"""`compile_train_multistep` of tiny CRIS e2e against the JAX package's,
with the BatchNorm statistics in the state (`tests/test_torch_multistep.py`
holds CLIPSeg, the accumulation window across a group boundary and the
loop; `tests/test_torch_multistep_denseclip.py` DenseCLIP). Both packages
start from the same numpy weights and take two groups of k = 2 steps over
batches stacked on a leading (k, B, ...) axis; a file of its own so that
its JAX compile runs beside the others'."""
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.cris import model as jcris  # noqa: E402
from tunevlseg_tpu.training.optim import partition_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_tpu.training.task import TrainState as JTrainState  # noqa: E402
from tunevlseg_torch.convert.from_jax import (model_state_from_jax,  # noqa: E402
                                              state_dict_from_jax,
                                              trainable_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.cris import model as tcris  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402
from tests.test_torch_accumulate import (KEY, _filled, _hold_weights,  # noqa: E402
                                         _trainable, _update_grads)
from tests.test_torch_multistep import (_jax_groups, _metrics_agree,  # noqa: E402
                                        _port_groups, _stack)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cris_pair(hp: dict, batch: dict):
    """Tiny CRIS e2e in both packages on the same weights: the JAX tree
    from `jax.eval_shape(init)` filled by a seeded numpy generator (Flax's
    `init` is slow op by op), running statistics that keep the random
    network alive (`tests/test_torch_cris.py::_live_stats`)."""
    from tests.test_torch_cris import _live_stats
    jm, jspec = jpresets.build_cris("e2e", config=jcris.CRISConfig.tiny())
    jtask = JTask(jm, jspec, **hp)
    shapes = jax.eval_shape(jm.init, KEY, batch["input_ids"],
                            jnp.zeros(batch["image"].shape, jnp.float32),
                            batch["attention_mask"], text_index=batch["text_index"])
    params = _filled(shapes["params"], 4)
    stats = _live_stats({"params": {}, "batch_stats": shapes["batch_stats"]})
    trainable, frozen_params = partition_params(params, jspec)
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable,
                         jtask.tx.init(trainable), jax.random.fold_in(KEY, 1),
                         {"batch_stats": stats["batch_stats"]})
    tm, tspec = tpresets.build_cris("e2e", config=tcris.CRISConfig.tiny(), seed=1,
                                    device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm, stats["batch_stats"]))
    return jtask, jstate, {"params": frozen_params}, SegmentationTask(tm, tspec, **hp)


def test_cris_e2e_multistep_with_batchnorm_statistics_matches_jax():
    """Two groups of k = 2 of tiny CRIS e2e (towers frozen, the head's
    train-mode BatchNorms): the metrics, the weights, and the running
    statistics the state carries out of each group (1e-4 of each tensor's
    largest entry, f32 batch moments summed in another order)."""
    from tests.test_torch_cris import _batch as _cris_batch
    k, lr = 2, 1e-3
    hp = dict(learning_rate=lr, weight_decay=0.01, grad_clip_norm=0.5,
              mutable_collections=("batch_stats",))
    batches = [_cris_batch(seed=s) for s in range(2 * k)]
    jtask, jstate, frozen, ttask = _cris_pair(hp, batches[0])
    groups = [_stack(batches[:k]), _stack(batches[k:])]
    jgroups = _jax_groups(jtask, k, jstate, frozen, groups)
    tm = ttask.model
    start = _trainable(tm)
    tstate = ttask.init()
    first_stats = dict(tstate.model_state)
    grads = _update_grads(tstate.optimizer, tm)
    tgroups = _port_groups(ttask.compile_train_multistep(k), tstate, groups)
    # a live train-mode network: the loss at 5e-5, dice and iou at 2e-3 (a
    # pixel across the threshold moves them by 1e-4; test_torch_cris.py)
    _metrics_agree(tgroups, jgroups, ("loss",), tol=5e-5)
    _metrics_agree(tgroups, jgroups, ("dice", "iou"), tol=2e-3)
    moved = 0
    for (tstate, _), (jst, _) in zip(tgroups, jgroups):
        want = model_state_from_jax(jst.model_state, tm)
        assert set(want) == set(tstate.model_state)
        for name, w in want.items():
            got = tstate.model_state[name]
            assert (got - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
            moved += int(not torch.equal(got, first_stats[name]))
    assert moved > 0
    n_robust = _hold_weights(_trainable(tm),
                             trainable_from_jax(jgroups[-1][0].trainable, tm),
                             start, grads, lambda name: 2 * k * lr * 1.05)
    assert n_robust > 100
