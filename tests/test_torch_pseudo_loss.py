"""The port's FreeSOLO / BoxInst pseudo losses
(`tunevlseg_torch/models/solov2/pseudo_loss.py`) against the JAX module
(`tunevlseg_tpu/models/solov2/pseudo_loss.py`) on seeded random inputs: each
function, and `paired_losses` with its gradient with respect to the mask
logits, with and without per-level means.

Tolerances: f32 in both packages, the same formulas; elementwise chains
(unfold, CIELAB, similarity, the pairwise term) agree to 1e-5 of their
scale (CIELAB values reach 100: 1e-4 absolute there), the losses, sums of a
few thousand terms, to 1e-5 relative, and the gradient to 1e-5 of its
largest entry."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.solov2 import pseudo_loss as jpl  # noqa: E402
from tunevlseg_torch.models.solov2 import pseudo_loss as tpl  # noqa: E402

ELEMENT_TOL = 1e-5
LAB_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL_TOL = 1e-5


def _both(fn_j, fn_t, *arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


@pytest.mark.parametrize("k,d", [(3, 2), (3, 1), (5, 2)])
def test_unfold_wo_center(k, d):
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 11)).astype(np.float32)
    got, want = _both(jpl.unfold_wo_center, tpl.unfold_wo_center, x,
                      kernel_size=k, dilation=d)
    assert got.shape == want.shape == (2, 3, k * k - 1, 9, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rgb2lab():
    rgb = np.random.default_rng(1).integers(0, 256, (4, 7, 3)).astype(np.float32)
    rgb[0, 0] = 0.0      # black and white: both branches of both functions
    rgb[0, 1] = 255.0
    got, want = _both(jpl.rgb2lab, tpl.rgb2lab, rgb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LAB_TOL)


def test_images_color_similarity():
    rng = np.random.default_rng(2)
    lab = (rng.standard_normal((2, 3, 8, 10)) * 40.0).astype(np.float32)
    mask = (rng.random((2, 8, 10)) > 0.2).astype(np.float32)
    got, want = _both(jpl.images_color_similarity, tpl.images_color_similarity,
                      lab, mask, kernel_size=3, dilation=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEMENT_TOL)


def test_compute_pairwise_term():
    logits = (np.random.default_rng(3).standard_normal((4, 1, 8, 10))
              * 3.0).astype(np.float32)
    got, want = _both(jpl.compute_pairwise_term, tpl.compute_pairwise_term,
                      logits, pairwise_size=3, pairwise_dilation=2)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEMENT_TOL * scale)


def test_prepare_color_similarity():
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 255, (2, 3, 32, 40)).astype(np.float32)
    masks = np.ones((2, 32, 40), np.float32)
    masks[1, :, 28:] = 0.0          # a padded border on the second image
    got, want = _both(jpl.prepare_color_similarity, tpl.prepare_color_similarity,
                      images, masks)
    assert got.shape == (2, 8, 8, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ELEMENT_TOL)


def test_dice_coefficient():
    rng = np.random.default_rng(5)
    x = rng.random((5, 8, 10)).astype(np.float32)
    t = (rng.random((5, 8, 10)) > 0.5).astype(np.float32)
    got, want = _both(jpl.dice_coefficient, tpl.dice_coefficient, x, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL,
                               atol=0)


def _instances(seed, n=6, h=24, w=20):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, h, w)) * 2.0).astype(np.float32)
    labels = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        labels[i, y0:y0 + rng.integers(3, h // 2), x0:x0 + rng.integers(3, w // 2)] = 1
    sim = rng.random((n, 8, h, w)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)[:n]
    levels = np.array([0, 0, 1, 3, 3, 4], np.int32)[:n]
    return logits, labels, sim, valid, levels


@pytest.mark.parametrize("per_level", [False, True], ids=["global", "per_level"])
@pytest.mark.parametrize("step", [0, 400, 5000])
def test_paired_losses_and_their_gradient(per_level, step):
    logits, labels, sim, valid, levels = _instances(6)
    kw = dict(step=step, num_levels=5)

    def jax_total(lg):
        out = jpl.paired_losses(lg, jnp.asarray(labels), jnp.asarray(sim),
                                jnp.asarray(valid),
                                level_ids=jnp.asarray(levels) if per_level else None,
                                **kw)
        return sum(out.values()), out

    (jtotal, jout), jgrad = jax.value_and_grad(jax_total, has_aux=True)(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    tout = tpl.paired_losses(lg, torch.from_numpy(labels), torch.from_numpy(sim),
                             torch.from_numpy(valid),
                             level_ids=torch.from_numpy(levels) if per_level else None,
                             **kw)
    sum(tout.values()).backward()
    assert set(tout) == set(jout) == {"loss_ins", "loss_ins_max", "loss_pairwise"}
    for key in tout:
        np.testing.assert_allclose(tout[key].item(), float(jout[key]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    if step == 0:
        assert tout["loss_pairwise"].item() == 0.0
    want = np.asarray(jgrad)
    got = lg.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_REL_TOL * np.abs(want).max())
    # invalid instances take no gradient
    assert not got[valid == 0].any()
