"""`compile_train_multistep` of tiny DenseCLIP `bn_train` against the JAX
package's: the poly schedule gives each step inside the program its own
learning rate, as inside the JAX scan (`tests/test_torch_multistep.py`
holds CLIPSeg, the accumulation window and the loop;
`tests/test_torch_multistep_cris.py` CRIS e2e). Both packages start from the
same numpy weights (the port's, as a JAX tree) and take two groups of k = 2
steps over batches stacked on a leading (k, B, ...) axis."""
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.denseclip import model as jdc_model  # noqa: E402
from tunevlseg_tpu.training import denseclip_task as jdc_task  # noqa: E402
from tunevlseg_tpu.training.task import TrainState as JTrainState  # noqa: E402
from tunevlseg_torch.convert.from_jax import trainable_from_jax  # noqa: E402
from tunevlseg_torch.training.denseclip_task import DenseCLIPTask  # noqa: E402
from tunevlseg_torch.training.denseclip_task import group_labels  # noqa: E402
from tests.test_torch_accumulate import (KEY, _hold_weights, _trainable,  # noqa: E402
                                         _update_grads)
from tests.test_torch_denseclip import _built as _dc_built  # noqa: E402
from tests.test_torch_denseclip import _jcfg as _dc_jcfg  # noqa: E402
from tests.test_torch_denseclip import _train_batch as _dc_train_batch  # noqa: E402
from tests.test_torch_multistep import (_jax_groups, _metrics_agree,  # noqa: E402
                                        _port_groups, _stack)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_denseclip_multistep_learning_rate_a_step_matches_jax():
    """Two groups of k = 2 of tiny DenseCLIP (RN, `bn_train`, head dropout 0)
    with a warm-up of 3 of 4 iterations: each step inside the program takes
    its own rate, as the JAX schedule does inside the scan. Losses at
    SCALAR_TOL, the weights at the strategy-parity rule (the backbone at
    lr x 0.1), the statistics at 1e-4 of each tensor's largest entry."""
    k = 2
    task_kw = dict(learning_rate=3e-3, weight_decay=1e-2, total_iters=4,
                   warmup_iters=3, image_stats=((0.485, 0.456, 0.406),
                                                (0.229, 0.224, 0.225)))
    cfg, ids, tm, variables = _dc_built("rn", cfg_kw=dict(head_dropout=0.0),
                                        bn_train=True)
    batches = [_dc_train_batch(cfg, seed=20 + i) for i in range(2 * k)]
    jt = jdc_task.DenseCLIPTask(
        jdc_model.DenseCLIP(_dc_jcfg(cfg), class_token_ids=ids, bn_train=True),
        **task_kw)
    params = variables["params"]
    trainable = {n: v for n, v in params.items() if n != "text_encoder"}
    frozen = {"params": {"text_encoder": params["text_encoder"]}}
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable, jt.tx.init(trainable),
                         jax.random.fold_in(KEY, 1),
                         {"batch_stats": variables["batch_stats"]})
    groups = [_stack(batches[:k]), _stack(batches[k:])]
    jgroups = _jax_groups(jt, k, jstate, frozen, groups)
    tt = DenseCLIPTask(tm, **task_kw)
    tstate = tt.init()
    start = _trainable(tm)
    grads = _update_grads(tstate.optimizer, tm)
    lrs = []
    tstate.optimizer.optimizer.register_step_pre_hook(lambda o, a, kw: lrs.append(
        [float(g["lr"]) for g in o.param_groups]))
    tgroups = _port_groups(tt.compile_train_multistep(k), tstate, groups)
    _metrics_agree(tgroups, jgroups, ("loss", "loss_decode", "loss_aux_identity"))
    # a rate a step: schedule(step) x lr_mult, four different ones
    assert lrs == [tt.learning_rates(tstate.optimizer, s) for s in range(2 * k)]
    assert len({round(r[0], 12) for r in lrs}) == 2 * k
    labels = {n: ("backbone" in g) for n, g in group_labels(tm).items()}
    total = sum(tt.schedule(s) for s in range(2 * k)) * 1.05
    n_robust = _hold_weights(
        _trainable(tm), trainable_from_jax(jgroups[-1][0].trainable, tm), start,
        grads, lambda name: total * (tt.backbone_lr_mult if labels[name] else 1.0))
    assert n_robust > 1000
    want = trainable_from_jax(jgroups[-1][0].model_state["batch_stats"], tm)
    got = tgroups[-1][0].model_state
    assert set(got) == set(want)
    for name, w in want.items():
        assert (got[name] - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
