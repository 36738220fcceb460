"""The port's segmentation losses (`tunevlseg_torch/ops/losses.py`) against
the JAX package's (`tunevlseg_tpu/ops/losses.py`) on the CPU: every option of
`dice_loss`, `dice_ce_loss`, `binary_cross_entropy_with_logits` and
`focal_loss`, passed as keywords and in the JAX argument order, on the same
numpy inputs; and every `loss_fn` block of the repository's configurations
(`name` picks the function from `LOSS_REGISTRY`, the other keys are keyword
arguments, as the JAX training CLI builds its task) building a port
`SegmentationTask` whose train step computes a finite loss equal to the JAX
function's on the same logits."""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.ops import losses as jlosses  # noqa: E402
from tunevlseg_torch.ops import losses as tlosses  # noqa: E402
from tunevlseg_torch.training.optim import FreezeSpec  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402

# f32 on the CPU in both packages, the same formulas: scalars of order 1 agree
# to a few f32 ulps of the reductions (other summation order)
TOL = 1e-6
CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _inputs(seed=0, shape=(4, 1, 16, 16)):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=shape)).astype(np.float32)
    mask = (rng.random(shape) > 0.6).astype(np.float32)
    mask[2] = 0.0   # an empty target
    return logits, mask


def _both(fn_name, logits, mask, *args, **kwargs):
    got = getattr(tlosses, fn_name)(torch.from_numpy(logits),
                                    torch.from_numpy(mask), *args, **kwargs)
    want = getattr(jlosses, fn_name)(jnp.asarray(logits), jnp.asarray(mask),
                                     *args, **kwargs)
    return got.item(), float(want)


DICE_OPTIONS = [{}, {"sigmoid": False}, {"squared_pred": True}, {"jaccard": True},
                {"batch": True}, {"smooth_nr": 0.0, "smooth_dr": 1e-6},
                {"squared_pred": True, "jaccard": True, "batch": True}]


@pytest.mark.parametrize("kw", DICE_OPTIONS, ids=str)
def test_dice_loss_matches_jax(kw):
    logits, mask = _inputs(1)
    if kw.get("sigmoid") is False:      # probabilities in, as MONAI takes them
        logits = 1 / (1 + np.exp(-logits))
    got, want = _both("dice_loss", logits, mask, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


DICE_CE_OPTIONS = [{}, {"sigmoid": True, "lambda_dice": 1, "lambda_ce": 0.2},
                   {"lambda_ce": 1.0}, {"weight": 5.8}, {"lambda_dice": 0.5},
                   {"squared_pred": True}, {"jaccard": True}, {"batch": True},
                   {"smooth_nr": 1e-3, "smooth_dr": 1e-3}, {"sigmoid": False}]


@pytest.mark.parametrize("kw", DICE_CE_OPTIONS, ids=str)
def test_dice_ce_loss_matches_jax(kw):
    logits, mask = _inputs(2)
    got, want = _both("dice_ce_loss", logits, mask, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_positional_order_is_the_jax_order():
    """(logits, targets, sigmoid, lambda_dice, lambda_ce, smooth_nr,
    smooth_dr, squared_pred, jaccard, batch, weight) and (logits, targets,
    sigmoid, squared_pred, jaccard, smooth_nr, smooth_dr, batch)."""
    logits, mask = _inputs(3)
    args = (True, 0.7, 0.4, 1e-4, 1e-3, True, False, True, 2.0)
    got, want = _both("dice_ce_loss", logits, mask, *args)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got, want = _both("dice_loss", logits, mask, True, True, True, 1e-4, 1e-3, False)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pos_weight", [None, 5.8])
def test_binary_cross_entropy_matches_jax(pos_weight):
    logits, mask = _inputs(4)
    got, want = _both("binary_cross_entropy_with_logits", logits, mask,
                      pos_weight=pos_weight)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (0.0, 0.5), (1.5, -1.0)])
def test_focal_loss_matches_jax(gamma, alpha):
    logits, mask = _inputs(5, shape=(3, 2, 8, 8))
    got, want = _both("focal_loss", logits, mask, gamma, alpha)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_registry_names_the_same_functions():
    assert set(tlosses.LOSS_REGISTRY) == set(jlosses.LOSS_REGISTRY)
    for name, fn in tlosses.LOSS_REGISTRY.items():
        assert fn.__name__ == jlosses.LOSS_REGISTRY[name].__name__


def _loss_blocks():
    """(file, block) of every `loss_fn` mapping under configs/."""
    def walk(node):
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "loss_fn":
                    yield value
                else:
                    yield from walk(value)
        elif isinstance(node, list):
            for value in node:
                yield from walk(value)

    for path in sorted(CONFIGS.rglob("*.yaml")):
        for block in walk(yaml.safe_load(path.read_text())):
            yield str(path.relative_to(CONFIGS)), block


LOSS_BLOCKS = list(_loss_blocks())


class _TinySegmenter(torch.nn.Module):
    """A model with the call the task makes: (ids, image, mask, ...) ->
    logits (B, 1, H, W)."""

    def __init__(self):
        super().__init__()
        self.head = torch.nn.Conv2d(3, 1, 1)

    def forward(self, input_ids, image, attention_mask=None, deterministic=True,
                generator=None):
        return self.head(image)


def test_every_config_loss_block_is_found():
    assert len(LOSS_BLOCKS) == 6, LOSS_BLOCKS
    assert sum("weight" in block for _, block in LOSS_BLOCKS) == 1


@pytest.mark.parametrize("path,block", LOSS_BLOCKS, ids=[p for p, _ in LOSS_BLOCKS])
def test_config_loss_block_builds_a_task_with_a_finite_loss(path, block):
    kwargs = dict(block)
    loss_fn = tlosses.LOSS_REGISTRY[kwargs.pop("name")]
    torch.manual_seed(0)
    task = SegmentationTask(_TinySegmenter(), FreezeSpec(always_trainable=("head",)),
                            loss_fn=loss_fn, loss_kwargs=kwargs)
    state = task.init()
    rng = np.random.default_rng(6)
    batch = {"input_ids": torch.ones(2, 8, dtype=torch.int64),
             "image": torch.from_numpy(rng.integers(0, 256, (2, 3, 16, 16),
                                                    dtype=np.uint8)),
             "mask": torch.from_numpy((rng.random((2, 1, 16, 16)) > 0.5)
                                      .astype(np.float32))}
    loss, logits = task._loss(batch)
    assert bool(torch.isfinite(loss))
    want = jlosses.LOSS_REGISTRY[block["name"]](
        jnp.asarray(logits.detach().numpy()), jnp.asarray(batch["mask"].numpy()),
        **kwargs)
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    _, metrics = task.train_step(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
