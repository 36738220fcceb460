"""The port's CLIP text and vision towers and their helpers against the JAX
package (tiny configs, f32, CPU): the prompt splice, the mask extension, EOS
pooling under both conventions, the position-embedding resize (pretraining
grid 2 -> input grid 4) and the early exit."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.clip import text as jtext  # noqa: E402
from tunevlseg_tpu.models.clip import vision as jvision  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.convert.from_jax import state_dict_from_jax  # noqa: E402
from tunevlseg_torch.models.clip import text as ttext  # noqa: E402
from tunevlseg_torch.models.clip import vision as tvision  # noqa: E402

# ~5-10 f32 layers, summation order differs between the frameworks
ATOL = RTOL = 1e-4
EOT = 49407


def _ids(rng, b, seq, eot_at):
    ids = rng.integers(3, 1000, size=(b, seq)).astype(np.int32)
    ids[:, 0] = 49406
    for row, pos in enumerate(eot_at):
        ids[row, pos:] = EOT
    return ids


def test_splice_and_mask_helpers_match_jax():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(3, 77, 8)).astype(np.float32)
    for ctx in (rng.normal(size=(4, 8)), rng.normal(size=(3, 4, 8))):
        ctx = ctx.astype(np.float32)
        for max_len in (77, None):
            want = jtext.splice_text_context(jnp.asarray(emb), jnp.asarray(ctx),
                                             max_len)
            got = ttext.splice_text_context(torch.from_numpy(emb),
                                            torch.from_numpy(ctx), max_len)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (3, 81, 8) and want.shape == (3, 81, 8)
    mask = (rng.random((3, 77)) > 0.3).astype(np.int32)
    for max_len, value in ((77, 1), (None, 0)):
        np.testing.assert_array_equal(
            ttext.extend_text_mask(torch.from_numpy(mask), 4, max_len, value).numpy(),
            np.asarray(jtext.extend_text_mask(jnp.asarray(mask), 4, max_len, value)))


@pytest.mark.parametrize("eos_token_id", [2, EOT])
def test_eos_pooled_indices_match_jax(eos_token_id):
    ids = _ids(np.random.default_rng(1), 4, 77, [9, 20, 75, 77])
    for n_ctx in (0, 4):
        np.testing.assert_array_equal(
            ttext.eos_pooled_indices(torch.from_numpy(ids), eos_token_id, n_ctx,
                                     77).numpy(),
            np.asarray(jtext.eos_pooled_indices(jnp.asarray(ids), eos_token_id,
                                                n_ctx, 77)))


def _load(tmodule, params):
    tmodule.load_state_dict(state_dict_from_jax(params, tmodule))
    return tmodule


@pytest.mark.parametrize("eos_token_id,prompted", [(2, True), (EOT, True),
                                                   (2, False)])
def test_text_tower_matches_jax(eos_token_id, prompted):
    cfg = dataclasses.replace(CLIPSegConfig.tiny().text, eos_token_id=eos_token_id)
    rng = np.random.default_rng(2)
    ids = _ids(rng, 3, 77, [9, 30, 75])
    mask = (ids != EOT).astype(np.int32)
    mask[:, 0] = 1
    ctx = (0.02 * rng.normal(size=(3, 4, cfg.hidden_size))).astype(np.float32)
    depth = 3 if prompted else 0
    jargs = (jnp.asarray(ids), jnp.asarray(mask),
             jnp.asarray(ctx) if prompted else None, depth)
    jm = jtext.CLIPTextTower(cfg)
    params = jm.init(jax.random.PRNGKey(0), *jargs)["params"]
    want_last, want_pooled = jm.apply({"params": params}, *jargs)
    # the port's tower takes the port's own config, same field values
    tcfg = tconfig.CLIPTextConfig(**dataclasses.asdict(cfg))
    tm = _load(ttext.CLIPTextTower(tcfg), params)
    with torch.no_grad():
        last, pooled = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                          torch.from_numpy(ctx) if prompted else None, depth)
    assert last.shape == want_last.shape
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("early_exit", [True, False])
def test_vision_tower_matches_jax(early_exit):
    cfg = CLIPSegConfig.tiny()
    vcfg = cfg.vision
    # 64 px at patch 16 is a 4x4 grid; the tiny pretraining grid is 2x2
    pix = np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32)
    extract = (1, 2) if early_exit else cfg.extract_layers
    jm = jvision.CLIPVisionTower(vcfg)
    kw = dict(extract_layers=extract, early_exit=early_exit)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pix), **kw)["params"]
    want_hidden, want_last, want_pooled = jm.apply({"params": params},
                                                   jnp.asarray(pix), **kw)
    tvcfg = tconfig.CLIPVisionConfig(**dataclasses.asdict(vcfg))
    tm = _load(tvision.CLIPVisionTower(tvcfg, extract, early_exit), params)
    with torch.no_grad():
        hidden, last, pooled = tm(torch.from_numpy(pix))
    assert len(tm.layers) == (3 if early_exit else vcfg.num_layers)
    assert len(hidden) == len(want_hidden)
    assert hidden[0].shape == (2, 17, vcfg.hidden_size)
    for got, want in zip(hidden, want_hidden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
    if early_exit:
        assert last is None and pooled is None and want_pooled is None
        assert tm.post_layernorm is None
    else:
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                                   atol=ATOL, rtol=RTOL)
