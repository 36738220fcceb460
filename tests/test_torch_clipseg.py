"""The whole serving slice of the port against the JAX package: tiny
CLIPSeg + CoOp (prompt depth 3, 4 contexts) and the e2e model, the JAX
`SegmentationTask.init` params carried over by `state_dict_from_jax`, then
predict_step / eval_step / the serving function on a uint8 batch with prompt
dedup (`text_index`). Also: the weight mapping covers every leaf both ways
(tiny and full width), the unported strategies raise, and the port imports
no JAX."""
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_tpu.ops import metrics as jmetrics  # noqa: E402
from tunevlseg_tpu.training.optim import merge_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params, port_name,  # noqa: E402
                                              state_dict_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.models.clipseg.model import CLIPSegForSegmentation  # noqa: E402
from tunevlseg_torch.models.prompt.learners import CoOpLearner  # noqa: E402
from tunevlseg_torch.ops import metrics as tmetrics  # noqa: E402
from tunevlseg_torch.serving import task_predict_fn  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask as TTask  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 logits through ~10 layers, summation order differs: 1e-4; the loss and
# the metric sums are reductions of those logits: 1e-5
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5


def _batch(seed=0, b=4, img=64, unique=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(unique, 12)).astype(np.int32)
    ids[:, 0] = 49406
    ids[0, 9:] = 49407
    ids[1:, 7:] = 49407
    return {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
            "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids, "attention_mask": (ids != 49407).astype(np.int32),
            "valid": np.array([1] * (b - 1) + [0], np.float32),
            "text_index": (np.arange(b) % unique).astype(np.int32)}


def _pair(strategy):
    cfg = CLIPSegConfig.tiny()
    tcfg = tconfig.CLIPSegConfig.tiny()     # the port's own, same field values
    batch = _batch()
    jmodel, spec = jpresets.build_clipseg(strategy, prompt_depth=3,
                                          num_context=4, config=cfg)
    jtask = JTask(jmodel, spec)
    state, frozen = jtask.init(jax.random.PRNGKey(0), batch)
    params = merge_params(state.trainable, frozen["params"])
    tmodel, _ = tpresets.build_clipseg(strategy, prompt_depth=3,
                                       num_context=4, config=tcfg, seed=1,
                                       device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel))
    return jtask, state, frozen, params, TTask(tmodel), batch


@pytest.mark.parametrize("strategy", ["coop", None])
def test_serving_slice_matches_jax(strategy):
    jtask, state, frozen, params, ttask, batch = _pair(strategy)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    want_logits = np.asarray(jtask._forward(params, {}, batch))
    with torch.no_grad():
        got_logits = ttask._forward(tbatch).numpy()
    assert got_logits.shape == (4, 1, 64, 64)
    np.testing.assert_allclose(got_logits, want_logits, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

    want_probs = np.asarray(jtask.predict_step(state, frozen, batch))
    got_probs = ttask.predict_step(tbatch)
    np.testing.assert_allclose(got_probs.numpy(), want_probs, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    served = task_predict_fn(ttask)(dict(ttask.model.named_parameters()), tbatch)
    torch.testing.assert_close(served, got_probs, rtol=0, atol=0)

    jstate, jaux = jtask.eval_step(state, frozen, jmetrics.SegMetricState.zeros(),
                                   batch)
    tstate, taux = ttask.eval_step(tmetrics.SegMetricState.zeros(), tbatch)
    for key in ("loss_sum", "n"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose([float(x) for x in tstate],
                               [float(x) for x in jstate], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    for key, value in tmetrics.compute(tstate).items():
        np.testing.assert_allclose(value.item(),
                                   float(jmetrics.compute(jstate)[key]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)


def test_text_dedup_matches_dense_rows():
    _, _, _, _, ttask, batch = _pair("coop")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    dense = dict(tbatch)
    idx = dense.pop("text_index").long()
    dense["input_ids"] = tbatch["input_ids"][idx]
    dense["attention_mask"] = tbatch["attention_mask"][idx]
    torch.testing.assert_close(ttask.predict_step(tbatch),
                               ttask.predict_step(dense), rtol=0, atol=2e-6)


def test_mapping_covers_every_leaf_both_ways():
    _, _, _, params, ttask, _ = _pair("coop")
    flat = flatten_params(params)
    names = {port_name(p)[0] for p in flat}
    assert names == set(ttask.model.state_dict())
    assert len(names) == len(flat)

    extra = {**params, "visual_projection": {"kernel": np.zeros((24, 20))}}
    with pytest.raises(KeyError, match="visual_projection"):
        state_dict_from_jax(extra, ttask.model)
    unknown = {**params, "decoder": {**params["decoder"],
                                     "film_mul": {"mystery": np.zeros(3)}}}
    with pytest.raises(KeyError, match="no mapping"):
        state_dict_from_jax(unknown, ttask.model)
    missing = {k: v for k, v in params.items() if k != "text_projection"}
    with pytest.raises(KeyError, match="unfilled.*text_projection"):
        state_dict_from_jax(missing, ttask.model)


def test_mapping_matches_full_width_param_set():
    """rd64 + CoOp(3, 4) at 352²: the JAX tree (shapes only, no compute)
    holds vision layers 0..9 and no post_layernorm, visual_projection or
    additive_head; the port builds exactly that set."""
    jmodel, _ = jpresets.build_clipseg("coop", prompt_depth=3, num_context=4)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 77), jnp.int32),
        jax.ShapeDtypeStruct((2, 3, 352, 352), jnp.float32),
        jax.ShapeDtypeStruct((1, 77), jnp.int32),
        text_index=jax.ShapeDtypeStruct((2,), jnp.int32))["params"]
    with torch.device("meta"):
        tmodel = CLIPSegForSegmentation(
            tpresets.clipseg_rd64_config(),
            CoOpLearner(prompt_depth=3, num_context=4, context_dim=512),
            additive_mode="unused")
    want = {}
    for path, leaf in flatten_params(shapes).items():
        name, transpose = port_name(path)
        want[name] = tuple(leaf.shape[::-1] if transpose else leaf.shape)
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert "vision_model.layers.9.mlp.fc2.weight" in got
    assert not any(k.startswith(("vision_model.layers.10", "visual_projection",
                                 "vision_model.post_layernorm", "additive_head"))
                   for k in got)


def test_context_vectors_init_overwrites_leading_depths():
    emb = np.random.default_rng(4).normal(size=(4, 16)).astype(np.float32)
    learner = CoOpLearner(prompt_depth=3, num_context=4, context_dim=16,
                          initializer_embeddings=emb)
    with torch.no_grad():
        learner.init_weights(torch.Generator().manual_seed(0))
    ctx = learner().text.detach()
    assert ctx.shape == (3, 4, 16)
    np.testing.assert_array_equal(ctx[0].numpy(), emb)
    assert 0.01 < ctx[1:].std().item() < 0.03      # N(0, 0.02) elsewhere


def test_unported_paths_raise():
    """What the port still does not take: an unknown strategy or additive
    mode, and prompt dedup under an image-conditioned learner (CoCoOp),
    which the JAX package refuses too. The strategies, additive modes and
    the rd64-refined head that used to raise here now build."""
    cfg = tconfig.CLIPSegConfig.tiny()
    for mode in ("plain", "residual"):
        assert hasattr(CLIPSegForSegmentation(cfg, additive_mode=mode),
                       "additive_head")
    with pytest.raises(ValueError, match="additive_mode"):
        CLIPSegForSegmentation(cfg, additive_mode="blend")
    with pytest.raises(ValueError, match="unknown strategy"):
        tpresets.build_clipseg("lora", config=cfg, device="cpu")
    refined = CLIPSegForSegmentation(
        tconfig.CLIPSegConfig.tiny(complex_transposed_convolution=True))
    assert not hasattr(refined.decoder, "head_up")
    assert refined.decoder.head_up1.weight.shape == (8, 4, 4, 4)
    tpresets.build_clipseg("vpt", config=cfg, device="cpu")

    model, _ = tpresets.build_clipseg("cocoop", prompt_depth=2, config=cfg,
                                      device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    args = (batch["input_ids"], batch["image"].float(), batch["attention_mask"])
    with pytest.raises(ValueError, match="image-conditioned"):
        model(*args, text_index=batch["text_index"])
    idx = batch["text_index"].long()
    with torch.no_grad():
        out = model(batch["input_ids"][idx], args[1], args[2][idx])
    assert out.shape == (4, 1, 64, 64) and bool(out.isfinite().all())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
def test_build_defaults_to_the_card_and_never_falls_back_to_the_cpu():
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        tpresets.build_clipseg("coop", config=tconfig.CLIPSegConfig.tiny())


def test_port_config_is_its_own_copy_of_the_jax_one():
    import dataclasses
    assert tconfig.CLIPSegConfig is not CLIPSegConfig
    for make in (lambda c: c(), lambda c: c.tiny()):
        assert (dataclasses.asdict(make(tconfig.CLIPSegConfig))
                == dataclasses.asdict(make(CLIPSegConfig)))


def test_port_runs_without_jax():
    """Every module of the port (the `train` and `eval` entry points, the
    serving export and the ops' registrations included), chip_smoke and
    every scripts/torch_*.py (`torch_export_model.py`,
    `torch_servebench.py` and the tools `torch_sweep.py`,
    `torch_train_mnist.py`, `torch_analyze_{prompts,phrasecut,zeroshot}.py`
    among them) import, and a tiny
    eval and a tiny train step of CLIPSeg (CoOp and the five other
    strategies), of CRIS (CoOp, CoCoOp, flat, e2e), of the
    TransformerSegmentor (CLIP and SigLIP towers, both upsampler layouts),
    of DenseCLIP (its own task, batch statistics) and a tiny zero-shot RIS
    request (fused and host loop), a rematted CLIPSeg window of two
    accumulated micro-steps, a two-step `compile_train_multistep` program
    (`training/graphs.py`), a tiny
    `Trainer.fit` with its checkpoints run, and converted checkpoints (a
    safetensors file through `train.load_pretrained` into a CoOp train step,
    the rd64-refined head's file into its forward), a DDP step in a gloo
    group of one and the rank grid there (`parallel/mesh.py`, the
    tensor-parallel plan), a zero-shot request over two devices, the pseudo
    losses and the distributed and tensor-parallel tests' rank modules, TPE asks, an MNIST epoch, the
    prompt analysis of the fit's checkpoints and a zero-shot top-k analysis,
    with jax/flax/optax
    (and regex) unimportable; afterwards neither a module of jax, nor one of
    the JAX package, nor transformers or safetensors has been loaded, and
    the fit from memory loaded no cv2."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "regex"):
            sys.modules[name] = None        # any import of them now fails
        import torch
        import tunevlseg_torch
        for mod in pkgutil.walk_packages(tunevlseg_torch.__path__,
                                         "tunevlseg_torch."):
            importlib.import_module(mod.name)
        import chip_smoke  # noqa: F401
        import glob, importlib.util, os
        scripts = sorted(glob.glob(os.path.join("scripts", "torch_*.py")))
        assert "scripts/torch_micro_attn.py" in scripts and len(scripts) >= 4
        assert {"scripts/torch_export_model.py",
                "scripts/torch_servebench.py", "scripts/torch_sweep.py",
                "scripts/torch_train_mnist.py",
                "scripts/torch_analyze_prompts.py",
                "scripts/torch_analyze_phrasecut.py",
                "scripts/torch_analyze_zeroshot.py"} <= set(scripts)
        script_modules = {}
        for path in scripts:
            spec = importlib.util.spec_from_file_location(
                os.path.basename(path)[:-3], path)
            script_modules[path] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(script_modules[path])
        for name in ("tunevlseg_torch.utils.tpe",
                     "tunevlseg_torch.models.simple_dense_net"):
            assert name in sys.modules, name
        assert "tunevlseg_torch.ops.flash_attention_variants" in sys.modules
        from tunevlseg_torch.models.clip.config import CLIPSegConfig
        from tunevlseg_torch.models.presets import build_clipseg
        from tunevlseg_torch.ops.metrics import SegMetricState
        from tunevlseg_torch.training.task import SegmentationTask
        model, spec = build_clipseg("coop", prompt_depth=3, num_context=4,
                                    config=CLIPSegConfig.tiny(), device="cpu")
        g = torch.Generator().manual_seed(0)
        ids = torch.randint(3, 999, (1, 12), generator=g, dtype=torch.int32)
        batch = {"image": torch.randint(0, 256, (2, 3, 32, 32), generator=g,
                                        dtype=torch.uint8),
                 "mask": torch.ones(2, 1, 32, 32), "input_ids": ids,
                 "text_index": torch.zeros(2, dtype=torch.int32)}
        task = SegmentationTask(model, spec)
        probs = task.predict_step(batch)
        state, aux = task.eval_step(SegMetricState.zeros(), batch)
        assert probs.shape == (2, 1, 32, 32) and bool(probs.isfinite().all())
        before = model.learner.context_vectors.detach().clone()
        train_state, metrics = task.train_step(task.init(), batch)
        assert train_state.step == 1 and bool(metrics["loss"].isfinite())
        assert not torch.equal(model.learner.context_vectors, before)
        # per-layer remat (nn/remat.py) and a window of two micro-steps
        from tunevlseg_torch.nn import remat
        rmodel, rspec = build_clipseg("coop", prompt_depth=3, num_context=4,
                                      config=CLIPSegConfig.tiny(), device="cpu")
        rtask = SegmentationTask(rmodel, rspec, remat=True,
                                 accumulate_grad_batches=2)
        rstate = rtask.init()
        for _ in range(2):
            rstate, rmetrics = rtask.train_step(rstate, batch)
        assert rstate.step == 2 and rstate.optimizer.mini_step == 0
        assert bool(rmetrics["loss"].isfinite()) and not remat.enabled()
        # the multi-step program (training/graphs.py; the eager steps here)
        assert "tunevlseg_torch.training.graphs" in sys.modules
        mstate, mmetrics = task.compile_train_multistep(2)(
            task.init(), {k: torch.stack([v, v]) for k, v in batch.items()})
        assert mstate.step == 2 and bool(mmetrics["loss"].isfinite())

        dense = dict(batch, input_ids=ids.expand(2, -1))
        del dense["text_index"]
        for strategy in ("cocoop", "vpt", "maple", "shared_separate",
                         "shared_attn"):
            over = (dict(proj_num_heads=2, proj_dim_feedforward=16)
                    if strategy == "shared_attn" else None)
            m, sp = build_clipseg(strategy, prompt_depth=3, num_context=4,
                                  config=CLIPSegConfig.tiny(), device="cpu",
                                  learner_overrides=over)
            t = SegmentationTask(m, sp)
            b = dense if strategy == "cocoop" else batch
            p = t.predict_step(b)
            assert p.shape == (2, 1, 32, 32) and bool(p.isfinite().all())
            before = m.learner.context_vectors.detach().clone()
            st, mt = t.train_step(t.init(), b)
            assert st.step == 1 and bool(mt["loss"].isfinite()), strategy
            assert not torch.equal(m.learner.context_vectors, before), strategy

        from tunevlseg_torch.models.cris.model import CRISConfig
        from tunevlseg_torch.models.presets import build_cris
        from tunevlseg_torch.serving import task_predict_fn
        for name in ("tunevlseg_torch.models.cris.resnet",
                     "tunevlseg_torch.models.cris.layers",
                     "tunevlseg_torch.models.cris.model",
                     "tunevlseg_torch.ops.conv_flat",
                     "tunevlseg_torch.ops.build"):
            assert name in sys.modules, name
        cris, cspec = build_cris("coop", prompt_depth=2, num_context=4,
                                 config=CRISConfig.tiny(dropout=0.2, img_size=32),
                                 device="cpu")
        ctask = SegmentationTask(cris, cspec)
        cprobs = ctask.predict_step(batch)
        cstate, caux = ctask.eval_step(SegMetricState.zeros(), batch)
        assert cprobs.shape == (2, 1, 32, 32) and bool(cprobs.isfinite().all())
        served = task_predict_fn(ctask)(dict(cris.state_dict()), batch)
        assert torch.equal(served, cprobs)
        # the serving export: CRIS's predict step exported for the CPU and
        # loaded back (the ops' registrations come with the loader)
        import tempfile as _tempfile
        from tunevlseg_torch import serving
        art = _tempfile.mkdtemp()
        serving.export_task_predict(ctask, dict(cris.state_dict()), batch, art,
                                    platforms=("cpu",))
        exported = serving.load_fn(art, device="cpu")(dict(cris.state_dict()), batch)
        assert torch.equal(exported, cprobs)
        for name in ("tunevlseg_torch.serving", "tunevlseg_torch.ops.library"):
            assert name in sys.modules, name
        before = cris.learner.context_vectors.detach().clone()
        stats = cris.visual.bn1.running_var.clone()
        train_state, cmetrics = ctask.train_step(ctask.init(), batch)
        assert train_state.step == 1 and bool(cmetrics["loss"].isfinite())
        assert not torch.equal(cris.learner.context_vectors, before)
        assert torch.equal(cris.visual.bn1.running_var, stats)
        cocoop, ccspec = build_cris("cocoop", prompt_depth=2, num_context=4,
                                    config=CRISConfig.tiny(img_size=32),
                                    device="cpu")
        cctask = SegmentationTask(cocoop, ccspec)
        ccstate, ccmetrics = cctask.train_step(cctask.init(), dense)
        assert ccstate.step == 1 and bool(ccmetrics["loss"].isfinite())

        # the flat backbone serves from the same weights, and the e2e model's
        # full fine-tune on it takes a step that moves the running statistics
        # of the head in the state and a backbone convolution's weight
        flat, _ = build_cris("coop", prompt_depth=2, num_context=4, layout="flat",
                             config=CRISConfig.tiny(dropout=0.2, img_size=32),
                             device="cpu")
        flat.load_state_dict(cris.state_dict())
        fprobs = SegmentationTask(flat).predict_step(batch)
        assert (fprobs - ctask.predict_step(batch)).abs().max() < 1e-4
        e2e, espec = build_cris("e2e", freeze_encoder=False, layout="flat",
                                config=CRISConfig.tiny(img_size=32), device="cpu")
        etask = SegmentationTask(e2e, espec, mutable_collections=("batch_stats",))
        estate = etask.init()
        weight = e2e.visual.layer1[0].conv2.weight.detach().clone()
        estate2, emetrics = etask.train_step(estate, batch)
        assert bool(emetrics["loss"].isfinite())
        assert not torch.equal(e2e.visual.layer1[0].conv2.weight, weight)
        key = "neck.aggr.bn.running_mean"
        assert not torch.equal(estate2.model_state[key], estate.model_state[key])
        assert torch.equal(e2e.neck.aggr.bn.running_mean, estate.model_state[key])
        # the TransformerSegmentor: both tower families serve and train; the
        # flat upsampler serves from the same weights
        from tunevlseg_torch.models.presets import build_trans_segmentor
        from tunevlseg_torch.models.trans_segmentor.model import (
            TransSegmentorConfig)
        for name in ("tunevlseg_torch.models.trans_segmentor.model",
                     "tunevlseg_torch.models.trans_segmentor.siglip"):
            assert name in sys.modules, name
        for family in ("clip", "siglip"):
            ts_cfg = TransSegmentorConfig.tiny(encoder_family=family)
            ts, ts_spec = build_trans_segmentor(ts_cfg, device="cpu")
            ts_task = SegmentationTask(ts, ts_spec)
            ts_probs = ts_task.predict_step(batch)
            assert ts_probs.shape == (2, 1, 32, 32), family
            ts_flat, _ = build_trans_segmentor(ts_cfg, upsampler_layout="flat",
                                               device="cpu")
            ts_flat.load_state_dict(ts.state_dict())
            flat_probs = SegmentationTask(ts_flat).predict_step(batch)
            assert (flat_probs - ts_probs).abs().max() < 1e-5, family
            before = ts.vision_model.layers[0].mlp.fc1.weight.detach().clone()
            ts_state, ts_metrics = ts_task.train_step(ts_task.init(), batch)
            assert bool(ts_metrics["loss"].isfinite()), family
            assert not torch.equal(ts.vision_model.layers[0].mlp.fc1.weight,
                                   before), family
        # DenseCLIP: a tiny bn_train step through its own task (uint8 images,
        # labels with an ignored band); the text encoder stays as it was and
        # the backbone's running statistics move in the state
        from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig
        from tunevlseg_torch.models.presets import build_denseclip
        from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
        for name in ("tunevlseg_torch.models.denseclip.loss",
                     "tunevlseg_torch.models.denseclip.inference"):
            assert name in sys.modules, name
        dc_cfg = DenseCLIPConfig.tiny()
        dc_ids = torch.randint(1, dc_cfg.vocab_size - 1, (dc_cfg.num_classes, 5),
                               generator=g)
        dc_ids[:, -1] = dc_cfg.vocab_size - 1
        dc = build_denseclip(dc_cfg, dc_ids, bn_train=True, device="cpu")
        dc_task = DenseCLIPTask(dc, image_stats=((0.5,) * 3, (0.25,) * 3),
                                warmup_iters=1)
        dc_state = dc_task.init()
        labels = torch.randint(0, dc_cfg.num_classes, (2, 64, 64), generator=g)
        labels[:, :4] = 255
        dc_batch = {"image": torch.randint(0, 256, (2, 3, 64, 64), generator=g,
                                           dtype=torch.uint8), "label": labels}
        text_before = dc.text_encoder.resblocks[0].mlp.fc1.weight.detach().clone()
        dc_state2, dc_metrics = dc_task.train_step(dc_state, dc_batch)
        assert bool(dc_metrics["loss"].isfinite()) and dc_state2.step == 1
        assert torch.equal(dc.text_encoder.resblocks[0].mlp.fc1.weight, text_before)
        key = "backbone.bn1.running_mean"
        assert not torch.equal(dc_state2.model_state[key], dc_state.model_state[key])
        # zero-shot RIS: a tiny fused request (FreeSOLO's R50 on the flat
        # layout, the device crop-resize at alpha 0.95) and the host loop
        from tunevlseg_torch.eval_zeroshot import build_ris
        for name in ("tunevlseg_torch.models.solov2.backbone",
                     "tunevlseg_torch.models.solov2.model",
                     "tunevlseg_torch.models.zero_shot_ris.model",
                     "tunevlseg_torch.models.zero_shot_ris.biomed_clip"):
            assert name in sys.modules, name
        zs = build_ris({"model": {"layout": "flat"}, "tiny_model": True},
                       device="cpu")
        zs_image = torch.randn(3, 64, 64, generator=g).numpy()
        zs_ids = ids[:1].expand(2, -1).numpy()
        zs_mask = torch.ones_like(ids[:1]).expand(2, -1).numpy()
        zs_fused = zs.predict_fused(zs_image, zs_ids, zs_mask)
        assert zs_fused.shape == (1, 1, 64, 64)
        assert (zs(zs_image, zs_ids, zs_mask) == zs_fused).all()
        # data parallel: a DDP step in a gloo group of one; the zero-shot
        # proposals over the CPU twice; the FreeSOLO pseudo losses; the test
        # ranks' own module
        import tempfile as _tmp
        from tunevlseg_torch.parallel import distributed
        distributed.initialize_distributed(
            {"coordinator_address": "file://" + _tmp.mkdtemp() + "/store",
             "num_processes": 1, "process_id": 0}, "cpu")
        dmodel, dspec = build_clipseg("coop", prompt_depth=3, num_context=4,
                                      config=CLIPSegConfig.tiny(), device="cpu")
        dtask = SegmentationTask(dmodel, dspec)
        dstate = dtask.init()
        dtask.compile_steps()
        dstate, dmetrics = dtask.train_step(dstate, batch)
        assert dtask.ddp is not None and bool(dmetrics["loss"].isfinite())
        # the rank grid in that group: no model axis, nothing sliced; the
        # tensor-parallel plan of a 1 x 2 grid's shape
        from tunevlseg_torch.parallel import mesh as tmesh
        from tunevlseg_torch.parallel import sharding_rules, tensor_parallel
        grid = tmesh.make_mesh(1)
        assert grid.model_size == 1 and distributed.data_size() == 1
        assert tensor_parallel.shard_model(dmodel, grid) == {}
        assert any(d is not None for d in sharding_rules.tp_param_specs(
            dmodel, tmesh.Mesh(1, 2)).values())
        distributed.destroy()
        zs2 = build_ris({"model": {}, "tiny_model": True, "n_devices": 2},
                        device="cpu")
        assert len(zs2.devices) == 2
        assert zs2.predict_fused(zs_image, zs_ids, zs_mask).shape == (1, 1, 64, 64)
        from tunevlseg_torch.models.solov2 import pseudo_loss
        logits = torch.randn(3, 16, 16, generator=g, requires_grad=True)
        pl = pseudo_loss.paired_losses(
            logits, (torch.rand(3, 16, 16, generator=g) > 0.5).float(),
            torch.rand(3, 8, 16, 16, generator=g), torch.ones(3), step=10)
        sum(pl.values()).backward()
        assert bool(logits.grad.isfinite().all())
        import tests.torch_distributed_ranks  # noqa: F401
        import tests.torch_tensor_parallel_ranks  # noqa: F401
        for name in ("tunevlseg_torch.parallel.mesh",
                     "tunevlseg_torch.parallel.sharding_rules",
                     "tunevlseg_torch.parallel.tensor_parallel",
                     "tunevlseg_torch.parallel.activation_sharding"):
            assert name in sys.modules, name
        # the training and evaluation entry points and their modules: a tiny
        # fit with checkpoints over the port's loader, then a restore
        for name in ("tunevlseg_torch.train", "tunevlseg_torch.eval",
                     "tunevlseg_torch.training.loop",
                     "tunevlseg_torch.training.checkpoint",
                     "tunevlseg_torch.data.tokenizer",
                     "tunevlseg_torch.data.transforms",
                     "tunevlseg_torch.data.datasets",
                     "tunevlseg_torch.data.opencv",
                     "tunevlseg_torch.data.open_domain",
                     "tunevlseg_torch.models.prompt.init_text",
                     "tunevlseg_torch.config.composer",
                     "tunevlseg_torch.config.instantiate",
                     "tunevlseg_torch.utils.logging",
                     "tunevlseg_torch.utils.config_tree",
                     "tunevlseg_torch.utils.task_wrapper"):
            assert name in sys.modules, name
        import tempfile
        import numpy as np
        from tunevlseg_torch.data.pipeline import DataLoader
        from tunevlseg_torch.training.checkpoint import CheckpointManager
        from tunevlseg_torch.training.loop import Trainer
        rng = np.random.default_rng(0)
        row = ids[0].numpy()
        samples = [{"image": rng.integers(0, 256, (3, 32, 32), dtype=np.uint8),
                    "mask": np.ones((1, 32, 32), np.float32), "input_ids": row,
                    "attention_mask": np.ones_like(row)} for _ in range(4)]
        out = tempfile.mkdtemp()
        fit_state = Trainer(task, out, max_epochs=1, log_image_num=0).fit(
            task.init(), DataLoader(samples, 2, text_dedup=1),
            DataLoader(samples, 2, text_dedup=1))
        back = CheckpointManager(out + "/checkpoints", model).restore(
            "last", task.init())
        assert back.step == fit_state.step == 2
        assert "cv2" not in sys.modules     # loading from memory needs none
        # converted checkpoints: a tiny HF CLIPSeg file in the safetensors
        # format through `train.load_pretrained` into a CoOp model, and one
        # with the rd64-refined head into the refined model's forward
        import dataclasses, os
        from tunevlseg_torch.convert.clipseg import (CLIPSEG_ELIDABLE,
                                                     load_checkpoint_params)
        from tunevlseg_torch.convert.from_jax import tensors_from_jax
        from tunevlseg_torch.train import (build_model_and_task, init_kwargs,
                                           load_pretrained)
        plain_file, refined_file = os.environ["NO_JAX_CHECKPOINTS"].split(os.pathsep)
        pcfg = {"pretrained_checkpoint": plain_file, "tiny_model": True,
                "trainer": {}, "model": {"family": "clipseg", "strategy": "coop",
                                         "prompt_depth": 2}}
        pre = load_pretrained(pcfg)
        pmodel, ptask = build_model_and_task(pcfg, None, pretrained=pre,
                                             device="cpu")
        pstate, pmetrics = ptask.train_step(ptask.init(**init_kwargs(pre)), batch)
        assert bool(pmetrics["loss"].isfinite())
        assert torch.equal(pmodel.text_model.token_embedding.weight,
                           pre["params"]["text_model.token_embedding.weight"])
        rcfg = dataclasses.replace(CLIPSegConfig.tiny(),
                                   complex_transposed_convolution=True)
        refined, rspec = build_clipseg("coop", prompt_depth=2, num_context=4,
                                       config=rcfg, device="cpu")
        rtask = SegmentationTask(refined, rspec)
        rtask.init(params=tensors_from_jax(load_checkpoint_params(
            refined_file, rcfg)), elidable=CLIPSEG_ELIDABLE)
        rprobs = rtask.predict_step(batch)
        assert rprobs.shape == (2, 1, 32, 32) and bool(rprobs.isfinite().all())
        assert refined.decoder.head_up1.weight.shape == (8, 4, 4, 4)
        # the tools: TPE asks, the MNIST trainer for an epoch, the prompt
        # analysis of the fit's run directory above, the zero-shot analysis
        # over the tiny RIS
        from tunevlseg_torch.utils.tpe import REFERENCE_SPACES, TPESampler
        sampler = TPESampler(REFERENCE_SPACES, seed=0, n_startup=2)
        for i in range(3):
            sampler.tell(sampler.ask(), float(i))
        mnist = script_modules["scripts/torch_train_mnist.py"].main(
            ["--synthetic", "--epochs", "1", "--device", "cpu"])
        assert mnist["val_acc"] > 0.5
        reports = script_modules["scripts/torch_analyze_prompts.py"].analyze(
            [__import__("pathlib").Path(out)], __import__("pathlib").Path(out) / "a",
            device="cpu")
        assert [r["tensor"] for r in reports] == ["learner/context_vectors"]
        assert len(reports[0]["nearest_token_ids"]) == 12
        item = {"image": zs_image, "mask": np.ones((64, 64), np.float32),
                "input_ids": zs_ids, "attention_mask": zs_mask}
        zs_top = script_modules["scripts/torch_analyze_zeroshot.py"].analyze(
            zs, [item], "topk", (1, 2))["result"]
        assert 0.0 <= zs_top["top1_dice"] <= zs_top["top2_dice"] <= 1.0
        loaded = [m for m in sys.modules
                  if m == "tunevlseg_tpu" or m.startswith("tunevlseg_tpu.")
                  or m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "transformers", "safetensors")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("no-jax ok", float(aux["loss_sum"]), float(metrics["loss"]),
              float(caux["loss_sum"]), float(cmetrics["loss"]))
    """)
    # the tiny HF CLIPSeg checkpoints the script loads, written here where
    # transformers and safetensors are
    pytest.importorskip("transformers")
    st_torch = pytest.importorskip("safetensors.torch")
    from tests.test_torch_convert import hf_clipseg
    folder = tempfile.mkdtemp()
    files = (os.path.join(folder, "clipseg.safetensors"),
             os.path.join(folder, "clipseg_refined.pt"))
    st_torch.save_file({k: v.contiguous() for k, v in
                        hf_clipseg(False)[0].state_dict().items()}, files[0])
    torch.save(hf_clipseg(True)[0].state_dict(), files[1])
    # one OpenMP thread: the tiny models' small ops otherwise wait on
    # descheduled threads when the test workers share the cores
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "NO_JAX_CHECKPOINTS": os.pathsep.join(files)}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout
