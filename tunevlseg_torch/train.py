"""Training entry point of the port.

    python -m tunevlseg_torch.train experiment=coop/clipseg \
        ds_name=kvasir_polyp prompt_index=0 paths.data_root=/data

The counterpart of `tunevlseg_tpu/train.py`, reading the same `configs/`:
builds the datasets and loaders, the model and its freeze spec from the
`model` group, then runs fit -> test (best) -> predict. The run goes to the
CUDA card; `+trainer.device=cpu` asks for the CPU, and without a card and
without that key the CLI raises.

It covers the families ported so far: CLIPSeg with the six prompt
strategies (`coop/*`, `cocoop/*`, `vpt`, `maple`, `shared_*`), its e2e
fine-tune and zero-shot-segmentation variant (`e2e_clipseg`,
`clipseg_zss`), CRIS (`coop/cris`, `cocoop/cris`, `e2e_cris`, `cris_zss`;
`+model.layout=flat` runs its backbone through the flat convolution), and
the TransformerSegmentor (`model=trans_seg`, `model=trans_seg_siglip`,
`experiment=phrasecut`; `+model.layout=flat` runs its upsampler through the
flat convolution). `pretrained_checkpoint=<file>` loads a converted
checkpoint (`load_pretrained`: CIDAS CLIPSeg rd64 / rd64-refined with
`model.complex_head=true`, the reference's wrapper checkpoints, OpenAI's
RN50 for CRIS, CLIPModel / SiglipModel or a whole TransformerSegmentor)
over the seeded weights. Options of slices not ported yet raise and name
their ROADMAP item; DenseCLIP trains through
`scripts/torch_train_denseclip.py` and zero-shot RIS is evaluated by
`python -m tunevlseg_torch.eval_zeroshot`.

Data parallel, one process per card (`parallel/distributed.py`):
`trainer.n_devices=k` starts k ranks on this host (null: every visible
card; on the CPU, k gloo ranks), each `data.batch_size / k` rows of the
global batch from its shard of the data, the model under
DistributedDataParallel or, with `trainer.fsdp=true`, sharded by
`fully_shard` (one process has nothing to shard: `fsdp` there runs the
plain path). Under torchrun the process joins the launcher's group;
`trainer.multihost=true` with `trainer.coordinator_address` /
`num_processes` / `process_id` joins a group across hosts (launch one
process per card on every host). Rank 0 logs and writes checkpoints and
the config; every data rank writes its shard of the prediction masks (its
model rank 0 under `model_parallel`).

Tensor and sequence parallelism (`parallel/mesh.py`,
`parallel/tensor_parallel.py`, `parallel/activation_sharding.py`):
`trainer.model_parallel=tp` lays the k ranks out as a (k / tp, tp) grid;
each group of tp consecutive ranks slices the frozen towers between them
(Megatron's column- and row-parallel products, the attention kernels on
each rank's heads) and takes one data shard, `data.batch_size / (k / tp)`
rows. `trainer.seq_shard=true` also shards the towers' residual stream
over the sequence (a no-op at tp = 1). `trainer.fsdp=true` composes: the
rest of the model is sharded over the data axis. A checkpoint holds whole
tensors whatever the grid, and so does the program `export_dir` writes on
any grid (`export_task`): global rank 0 traces a whole model built again
from the config, with the run's tensors gathered into it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch

from tunevlseg_torch.config.composer import compose
from tunevlseg_torch.data.datasets import ImageTextMaskDataset
from tunevlseg_torch.data.pipeline import DataLoader
from tunevlseg_torch.data.tokenizer import load_default_tokenizer
from tunevlseg_torch.data.transforms import eval_transforms, train_transforms
from tunevlseg_torch.models.presets import (build_clipseg, build_cris,
                                            build_trans_segmentor)
from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
from tunevlseg_torch.ops.losses import LOSS_REGISTRY
from tunevlseg_torch.parallel import distributed
from tunevlseg_torch.parallel.mesh import make_mesh
from tunevlseg_torch.training.loop import EarlyStopping, Trainer
from tunevlseg_torch.training.optim import ReduceLROnPlateau, count_params
from tunevlseg_torch.training.task import SegmentationTask
from tunevlseg_torch.utils import profiling
from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"

# model families without a port yet, and the ROADMAP item each waits for:
# none left, every family of the JAX package is ported
UNPORTED_FAMILIES: dict[str, str] = {}
# DenseCLIP trains outside this CLI, in the port as in the JAX package, and
# zero-shot RIS does not train: it has an entry point of its own
DENSECLIP_SCRIPT = "scripts/torch_train_denseclip.py"
ZERO_SHOT_ENTRY = "python -m tunevlseg_torch.eval_zeroshot"


def check_ported(cfg: dict) -> None:
    """Raise on an option of a slice that is not ported yet, naming its
    ROADMAP item, on `family: denseclip`, which trains through its own
    script, and on `family: zero_shot_ris`, which is evaluated through its
    own entry point."""
    m, t = cfg["model"], cfg["trainer"]
    family = m.get("family", "clipseg")
    if family == "denseclip":
        raise NotImplementedError(
            "model family 'denseclip' does not train through this CLI (the "
            f"JAX CLI has no such family either): run {DENSECLIP_SCRIPT}, the "
            "mmseg recipe's trainer over training/denseclip_task.py")
    if family == "zero_shot_ris":
        raise NotImplementedError(
            "model family 'zero_shot_ris' is training-free and does not run "
            f"through this CLI: evaluate it with {ZERO_SHOT_ENTRY} (the JAX "
            "package's eval_zeroshot)")
    if family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported: {UNPORTED_FAMILIES[family]}")
    if family not in ("clipseg", "cris", "trans_segmentor"):
        raise NotImplementedError(f"model family {family}")


def resolve_device(cfg: dict) -> torch.device:
    """`trainer.device` (default "cuda"); a CUDA device that is not there
    raises, there is no fallback to the CPU."""
    device = torch.device(cfg["trainer"].get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this CLI runs on the card; pass "
            "+trainer.device=cpu to run on the CPU")
    return device


def build_datasets(cfg: dict, tokenizer) -> dict[str, Any]:
    d = cfg["data"]
    img = cfg["img_size"]
    mean, std = cfg["img_mean"], cfg["img_std"]
    nod = d.get("normalize_on_device", True)
    base = dict(insert_stop_at_last=cfg.get("insert_stop_at_last", True),
                tokenizer=tokenizer, max_length=cfg.get("max_length", 77),
                tokenizer_style=d.get("tokenizer_style", "hf"),
                seed=cfg.get("seed", 0))

    def dirs(split):
        """Per-split directory overrides (`<split>_image_dir`): the camus
        preset points train/val at images/train and test at images/test."""
        return dict(image_dir=d.get(f"{split}_image_dir", d["image_dir"]),
                    mask_dir=d.get(f"{split}_mask_dir", d["mask_dir"]))

    ds_type = d.get("type", "image_text_mask")

    if ds_type == "image_dir":
        # binarized class-directory suites (class name = prompt)
        from tunevlseg_torch.data.datasets import ImageDirTextMaskDataset

        def make(split, tf):
            return ImageDirTextMaskDataset(
                mask_suffix=d.get("mask_suffix", ".png"),
                image_suffix=d.get("image_suffix", ".png"),
                transforms=tf, **dirs(split), **base)

        eval_tf = eval_transforms(img, mean, std, nod)
        if "train_image_dir" in d:
            return {"train": make("train",
                                  train_transforms(img, mean, std, nod)),
                    "val": make("val", eval_tf),
                    "test": make("test", eval_tf)}
        ds = make("test", eval_tf)
        return {"train": ds, "val": ds, "test": ds}
    if ds_type in ("phrasecut", "refcoco"):
        from tunevlseg_torch.data.open_domain import (PhraseCutDataset,
                                                      RefCOCODataset)
        cls = PhraseCutDataset if ds_type == "phrasecut" else RefCOCODataset
        od = dict(base, prompt_method=d.get("prompt_method", "fixed"),
                  neg_prob=d.get("neg_prob", 0.0))
        # template prompts end in "." already
        od.pop("insert_stop_at_last", None)
        return {
            "train": cls(task_path=d["train_task_path"],
                         transforms=train_transforms(img, mean, std, nod),
                         **dirs("train"), **od),
            "val": cls(task_path=d["val_task_path"],
                       transforms=eval_transforms(img, mean, std, nod),
                       **dirs("val"), **dict(od, neg_prob=0.0)),
            "test": cls(task_path=d["test_task_path"],
                        transforms=eval_transforms(img, mean, std, nod),
                        **dirs("test"), **dict(od, neg_prob=0.0)),
        }

    common = dict(base, prompt_index=cfg["prompt_index"],
                  override_prompt=cfg.get("override_prompt"))
    return {
        "train": ImageTextMaskDataset(
            task_path=d["train_task_path"],
            transforms=train_transforms(img, mean, std, nod),
            **dirs("train"), **common),
        "val": ImageTextMaskDataset(
            task_path=d["val_task_path"],
            transforms=eval_transforms(img, mean, std, nod),
            **dirs("val"), **common),
        "test": ImageTextMaskDataset(
            task_path=d["test_task_path"],
            transforms=eval_transforms(img, mean, std, nod),
            **dirs("test"), **common),
    }


def _initializer_embeddings(cfg: dict, tokenizer, pretrained):
    """Embed the text context initializer ("a photo of a") through the
    token embedding of the pretrained weights (`load_pretrained`'s result,
    or a `state_dict`); the token count overrides num_context. Returns
    (embeddings, num_context); without pretrained weights the contexts stay
    random, as in the JAX CLI."""
    m = cfg["model"]
    init_text = m.get("context_initializer")
    if not init_text or tokenizer is None or pretrained is None:
        return None, m.get("num_context", 4)
    pretrained = pretrained.get("params", pretrained)
    key = ("text.token_embedding.weight" if m.get("family") == "cris"
           else "text_model.token_embedding.weight")
    if key not in pretrained:
        return None, m.get("num_context", 4)
    from tunevlseg_torch.models.prompt.init_text import (
        compute_initializer_embeddings)
    table = torch.as_tensor(pretrained[key]).float().cpu().numpy()
    emb = compute_initializer_embeddings(table, tokenizer, init_text)
    return emb, emb.shape[1]


def build_model_and_task(cfg: dict, tokenizer=None, pretrained=None,
                         device="cuda"):
    """The model (seeded random weights on `device`) and its task from the
    composed config. `pretrained` is `load_pretrained`'s result (or a
    `state_dict`); only its token embedding is read here, to initialise the
    context vectors from `model.context_initializer`. The weights themselves
    go in at `task.init(**init_kwargs(pretrained))`."""
    check_ported(cfg)
    m = cfg["model"]
    family = m.get("family", "clipseg")
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[
        cfg["trainer"].get("precision", "f32")]

    if family == "trans_segmentor":
        # the towers train unless freeze_encoders; no prompt learner
        model, spec = build_trans_segmentor(
            trans_segmentor_config(cfg),
            freeze_encoders=bool(m.get("freeze_encoders", False)),
            upsampler_layout=m.get("layout", "nchw"), dtype=dtype,
            device=device, seed=cfg.get("seed", 0))
        return model, _make_task(cfg, model, spec)

    init_emb, num_context = _initializer_embeddings(cfg, tokenizer, pretrained)
    common = dict(
        strategy=m.get("strategy", "coop"),
        prompt_depth=m.get("prompt_depth", 1),
        num_context=num_context,
        use_new_last_layer=m.get("use_new_last_layer", True),
        freeze_all=m.get("freeze_all", True),
        no_freeze_last_layer=m.get("no_freeze_last_layer", False),
        freeze_encoder=m.get("freeze_encoder"),  # zss: frozen towers
        dtype=dtype,
        learner_overrides=m.get("learner"),
        initializer_embeddings=init_emb,
        device=device,
        seed=cfg.get("seed", 0),
    )
    if family == "clipseg":
        from tunevlseg_torch.models.presets import clipseg_rd64_config
        config = clipseg_rd64_config(m.get("complex_head", False))
        if cfg.get("tiny_model"):  # test / debug hook
            from tunevlseg_torch.models.clip.config import CLIPSegConfig
            config = CLIPSegConfig.tiny()
        model, spec = build_clipseg(config=config,
                                    freeze_decoder=m.get("freeze_decoder",
                                                         False), **common)
    else:
        from tunevlseg_torch.models.presets import cris_rn50_config
        config = cris_rn50_config(cfg.get("img_size", 416))
        if cfg.get("tiny_model"):
            from tunevlseg_torch.models.cris.model import CRISConfig
            config = CRISConfig.tiny(img_size=cfg.get("img_size", 64))
        if "dropout" in m:  # decoder dropout (reference e2e_cris.yaml:32)
            config = dataclasses.replace(config, dropout=m["dropout"])
        model, spec = build_cris(config=config,
                                 layout=m.get("layout", "nchw"), **common)
    return model, _make_task(cfg, model, spec)


def trans_segmentor_config(cfg: dict) -> TransSegmentorConfig:
    """The TransSegmentorConfig of the composed config (the JAX CLI's
    `trans_segmentor_config`): the tiny, the SigLIP-base or the default
    (CLIP ViT-B/16) base, with the `model` group's options over it; tiny
    keeps its scaled-down decoder and upsampler."""
    m = cfg["model"]
    tiny = bool(cfg.get("tiny_model"))
    if tiny:
        base = TransSegmentorConfig.tiny()
    elif m.get("encoder_family", "clip") == "siglip":
        base = TransSegmentorConfig.siglip_base()
    else:
        base = TransSegmentorConfig()
    overrides = dict(
        encoder_family=m.get("encoder_family", "clip"),
        use_existing_proj=m.get("use_existing_proj", True),
        add_pos_enc=m.get("add_pos_enc", False),
        decoder_dropout=m.get("decoder_dropout", 0.1),
        decoder_activation=m.get("decoder_activation", "relu"),
        upsampler_act=m.get("upsampler_act", "relu"),
        upsampler_norm=m.get("upsampler_norm", "layer"),
        num_output_channels=m.get("num_output_channels", 1),
        output_bias=m.get("output_bias"),
        image_size=cfg.get("img_size"))
    if not tiny:
        overrides.update(
            decoder_num_layers=m.get("decoder_num_layers", 4),
            decoder_num_heads=m.get("decoder_num_heads", 8),
            decoder_dim_feedforward=m.get("decoder_dim_feedforward", 2048),
            num_upsampler_layers=m.get("num_upsampler_layers", 5))
    return dataclasses.replace(base, **overrides)


def _make_task(cfg: dict, model, spec):
    m = cfg["model"]
    loss_cfg = dict(m.get("loss_fn", {"name": "dice_ce"}))
    loss_fn = LOSS_REGISTRY[loss_cfg.pop("name")]
    opt = m.get("optimizer", {})
    mutable = (("batch_stats",) if getattr(model, "bn_train", False) else ())
    return SegmentationTask(
        model, spec, loss_fn=loss_fn, loss_kwargs=loss_cfg,
        threshold=m.get("threshold", 0.5),
        learning_rate=opt.get("lr", 2e-4),
        weight_decay=m.get("weight_decay", 0.0),
        grad_clip_norm=cfg["trainer"].get("gradient_clip_val"),
        accumulate_grad_batches=int(
            cfg["trainer"].get("accumulate_grad_batches", 1) or 1),
        remat=bool(cfg["trainer"].get("remat", False)),
        mutable_collections=mutable,
        seed=cfg.get("seed", 0),
        image_stats=(tuple(cfg.get("img_mean", (0.485, 0.456, 0.406))),
                     tuple(cfg.get("img_std", (0.229, 0.224, 0.225)))))


def load_pretrained(cfg: dict) -> Optional[dict]:
    """Read and convert `pretrained_checkpoint` where one is configured (the
    JAX CLI's `load_pretrained`): {"params": {name: f32 CPU tensor},
    "batch_stats": {name: tensor} (CRIS's BatchNorm statistics, else empty),
    "elidable": the name prefixes of checkpoint tensors the model may not
    build}, in the port's names; None without a checkpoint, and the model
    keeps its seeded weights (logged).

    clipseg: `convert/clipseg.load_checkpoint_params` at
    `clipseg_rd64_config(model.complex_head)` (the tiny config with
    `tiny_model`); cris: `convert/cris.load_cris_checkpoint` at
    `cris_rn50_config(img_size)` (the tiny config with `tiny_model`) with
    the strategy's learner; trans_segmentor: the reference's whole
    checkpoint or a bare CLIPModel / SiglipModel at
    `trans_segmentor_config(cfg)`, the dimensions the model is built
    with."""
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    path = cfg.get("pretrained_checkpoint")
    m = cfg["model"]
    family = m.get("family", "clipseg")
    if not path:
        if family in ("clipseg", "cris", "trans_segmentor"):
            log.warning("no pretrained_checkpoint given: the towers keep their "
                        "RANDOM seeded weights")
        return None
    check_ported(cfg)
    if family == "cris":
        from tunevlseg_torch.convert.cris import (CRIS_ELIDABLE,
                                                  load_cris_checkpoint)
        from tunevlseg_torch.models.cris.model import CRISConfig
        from tunevlseg_torch.models.presets import cris_rn50_config
        config = (CRISConfig.tiny(img_size=cfg.get("img_size", 64))
                  if cfg.get("tiny_model")
                  else cris_rn50_config(cfg.get("img_size", 416)))
        trees = load_cris_checkpoint(path, config, m.get("strategy"))
        elidable = CRIS_ELIDABLE
    elif family == "trans_segmentor":
        from tunevlseg_torch.convert.trans_segmentor import (
            TRANS_SEGMENTOR_ELIDABLE, load_trans_segmentor_checkpoint)
        trees = {"params": load_trans_segmentor_checkpoint(
            path, trans_segmentor_config(cfg))}
        elidable = TRANS_SEGMENTOR_ELIDABLE
    else:
        from tunevlseg_torch.convert.clipseg import (CLIPSEG_ELIDABLE,
                                                     load_checkpoint_params)
        from tunevlseg_torch.models.clip.config import CLIPSegConfig
        from tunevlseg_torch.models.presets import clipseg_rd64_config
        config = (CLIPSegConfig.tiny() if cfg.get("tiny_model")
                  else clipseg_rd64_config(m.get("complex_head", False)))
        trees = {"params": load_checkpoint_params(path, config, m.get("strategy"))}
        elidable = CLIPSEG_ELIDABLE
    return {"params": tensors_from_jax(trees["params"]),
            "batch_stats": tensors_from_jax(trees.get("batch_stats", {})),
            "elidable": elidable}


def init_kwargs(pretrained: Optional[dict]) -> dict:
    """`SegmentationTask.init`'s arguments for `load_pretrained`'s result."""
    if pretrained is None:
        return {}
    return {"params": pretrained["params"],
            "variables": {"batch_stats": pretrained["batch_stats"]},
            "elidable": pretrained["elidable"]}


def save_composed_config(cfg: dict, output_dir: Path) -> None:
    """The fully composed config next to the run outputs (the reference's
    hydra `.hydra/config.yaml`)."""
    import yaml

    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "config.yaml", "w") as fp:
        yaml.safe_dump(cfg, fp, default_flow_style=False, sort_keys=False)


def check_text_dedup(cfg: dict, multihost_datasets: Optional[dict] = None
                     ) -> int:
    """`data.text_dedup` (U rows of unique prompts a batch), checked
    against the model: CoCoOp's text stack is per image. With
    `multihost_datasets` (a run across hosts) only U = 1 over datasets that
    each select one constant prompt passes, as in the JAX CLI: the hosts
    hold disjoint shards and must still agree on the dedup rows. Ranks on
    one host dedup their own rows and need no such gate."""
    td = int(cfg["data"].get("text_dedup", 0) or 0)
    if td:
        if cfg["model"].get("strategy") == "cocoop":
            raise ValueError("data.text_dedup is incompatible with CoCoOp "
                             "(image-conditioned text stack)")
        if multihost_datasets is not None:
            if td != 1:
                raise ValueError(
                    f"data.text_dedup={td} is single-host only; multi-host "
                    "supports only text_dedup=1 with a provably constant "
                    "prompt")
            bad = [split for split, ds in multihost_datasets.items()
                   if getattr(ds, "fixed_prompt", lambda: None)() is None]
            if bad:
                raise ValueError(
                    "data.text_dedup under multi-host requires every dataset "
                    "to select one constant prompt (a scalar entry at a fixed "
                    f"prompt_index); splits {bad} do not: set "
                    "data.text_dedup=0")
        elif int(cfg.get("prompt_index", 0)) < 0:
            log.warning(
                "data.text_dedup=%d with prompt_index=-1 (random prompt "
                "per sample): batches whose distinct prompts exceed the "
                "capacity fall back to DENSE collation (slower). Set "
                "data.text_dedup=0 to silence.", td)
    return td


def ranks_to_start(cfg: dict) -> int:
    """How many ranks this process starts on its host: `trainer.n_devices`
    (null: every visible card, one on the CPU), or 1 where the process is
    a rank of a group launched elsewhere (torchrun, `multihost`). More
    ranks than visible cards, ranks that `trainer.model_parallel` does not
    divide, or a batch that does not split evenly over the data axis,
    raises a ValueError."""
    t = cfg["trainer"]
    check_ported(cfg)
    if t.get("multihost") or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return 1
    device = resolve_device(cfg)
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    n = t.get("n_devices")
    n = int(n) if n is not None else (cards or 1)
    if n < 1:
        raise ValueError(f"trainer.n_devices={n}: at least one rank")
    if cards is not None and n > cards:
        raise ValueError(f"trainer.n_devices={n}, but {cards} card(s) are "
                         "visible: one rank a card")
    tp = model_parallel(cfg)
    if n % tp:
        raise ValueError(f"{n} ranks not divisible by model_parallel={tp}")
    check_batch(cfg, n // tp, tp)
    return n


def model_parallel(cfg: dict) -> int:
    return int(cfg["trainer"].get("model_parallel", 1) or 1)


def check_batch(cfg: dict, data_ranks: int, tp: int) -> None:
    """The global batch must split evenly over the ranks of the data axis."""
    batch = cfg["data"]["batch_size"]
    if batch % data_ranks:
        raise ValueError(
            f"global data.batch_size {batch} must divide by the {data_ranks} "
            "ranks" + (f" of the data axis (model_parallel={tp})" if tp > 1 else ""))


def main(argv: Optional[list[str]] = None) -> dict:
    overrides = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "train", overrides)
    from tunevlseg_torch.utils.task_wrapper import run_guarded

    def run() -> dict:
        n = ranks_to_start(cfg)
        return start_ranks(_run, cfg, n) if n > 1 else _run(cfg)
    return run_guarded(run, cfg["paths"]["output_dir"])


def start_ranks(fn, cfg: dict, n: int) -> dict:
    """`fn(cfg)` in `n` new processes, the ranks 0 .. n - 1 of a process
    group that meets through a file in a fresh temporary directory; each
    takes its share of this process's CPU threads. Returns rank 0's
    result; a rank that fails stops the others, and the error is raised
    here."""
    import torch.multiprocessing as mp
    rendezvous = Path(tempfile.mkdtemp(prefix="tunevlseg-ranks-"))
    queue = mp.get_context("spawn").SimpleQueue()
    try:
        mp.start_processes(
            _rank_main, args=(n, fn, cfg, f"file://{rendezvous / 'store'}",
                              queue, max(1, torch.get_num_threads() // n)),
            nprocs=n, join=True, start_method="spawn")
        return queue.get()
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def _rank_main(rank: int, world: int, fn, cfg: dict, url: str, queue,
               threads: int) -> None:
    """One rank of `start_ranks`: join the group on this rank's card (or
    the CPU), run `fn(cfg)`, leave the group; rank 0 hands back its
    result."""
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    t = dict(cfg["trainer"], coordinator_address=url, num_processes=world,
             process_id=rank)
    distributed.initialize_distributed(t, resolve_device(cfg))
    try:
        result = fn(cfg)
    finally:
        distributed.destroy()
    if rank == 0:
        queue.put(result)


def join_group(cfg: dict, device: torch.device) -> tuple[torch.device, list]:
    """(this rank's device, what to undo at the end): the group a launcher
    made already, or the one `trainer.multihost` or torchrun describes.
    Without any of them: the run's device, no group."""
    t = cfg["trainer"]
    if distributed.is_initialized():
        return distributed.rank_device(device), []
    if t.get("multihost") or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        keys = t if t.get("multihost") else {}
        return (distributed.initialize_distributed(keys, device),
                [distributed.destroy])
    return device, []


def _run(cfg: dict) -> dict:
    check_ported(cfg)
    device, undo = join_group(cfg, resolve_device(cfg))
    try:
        return _run_rank(cfg, device)
    finally:
        for fn in undo:
            fn()


def _run_rank(cfg: dict, device: torch.device) -> dict:
    from tunevlseg_torch.utils.config_tree import apply_extras
    apply_extras(cfg, save_dir=cfg["paths"].get("output_dir"))
    grid = make_mesh(model_parallel(cfg))
    # the loaders shard over the data axis; a model group shares its shard
    world, rank = grid.data_size, grid.data_rank
    lead = distributed.rank() == 0
    if cfg.get("debug_nans"):
        # reference debug/default.yaml detect_anomaly: fail fast on NaNs
        torch.autograd.set_detect_anomaly(True)

    seed = cfg.get("seed", 0)
    tokenizer = load_default_tokenizer(cfg.get("vocab_path"),
                                       family=cfg.get("tokenizer_family", "clip"))
    datasets = build_datasets(cfg, tokenizer)
    pretrained = load_pretrained(cfg)
    model, task = build_model_and_task(cfg, tokenizer, pretrained=pretrained,
                                       device=device)

    t = cfg["trainer"]
    d = cfg["data"]
    check_batch(cfg, world, grid.model_size)
    td = check_text_dedup(cfg, datasets if t.get("multihost") else None)
    loaders = {
        split: DataLoader(ds, d["batch_size"] // world,
                          shuffle=(split == "train"), seed=seed,
                          num_workers=d.get("num_workers", 8),
                          drop_last=d.get("drop_last", False),
                          num_shards=world, shard_index=rank, text_dedup=td)
        for split, ds in datasets.items()
    }
    if td and t.get("multihost"):
        distributed.assert_dedup_keys_agree(next(iter(loaders["val"])))
    state = task.init(**init_kwargs(pretrained))

    sched_cfg = cfg["model"].get("scheduler") or {}
    scheduler = None
    if sched_cfg.get("name") == "plateau":
        scheduler = ReduceLROnPlateau(
            factor=sched_cfg.get("factor", 0.2),
            patience=sched_cfg.get("patience", 5),
            mode=sched_cfg.get("mode", "min"))

    # one process has nothing to shard: FSDP over it would only add the
    # gathers' copies, so it runs the plain path
    fsdp = bool(t.get("fsdp")) and world > 1
    if t.get("fsdp") and not fsdp:
        log.info("trainer.fsdp over a data axis of one rank: nothing to shard, "
                 "the plain path runs")
    es_cfg = t.get("early_stopping") or {}
    trainer = Trainer(
        task=task, output_dir=cfg["paths"]["output_dir"],
        max_epochs=t.get("max_epochs", 20), min_epochs=t.get("min_epochs", 1),
        log_every_n_steps=t.get("log_every_n_steps", 6),
        scheduler=scheduler,
        early_stopping=EarlyStopping(
            patience=es_cfg.get("patience", 12),
            min_delta=es_cfg.get("min_delta", 1e-4)),
        limit_batches=t.get("limit_batches"),
        loggers=tuple(t.get("loggers", ("jsonl", "csv"))),
        log_image_num=t.get("log_image_num", 4),
        steps_per_execution=t.get("steps_per_execution", 1),
        ckpt_every_n_steps=int(t.get("ckpt_every_n_steps", 0) or 0),
        fsdp=fsdp, mesh=grid, seq_shard=bool(t.get("seq_shard", False)),
        exp_name=cfg.get("exp_name"), project=t.get("project"),
        tags=tuple(cfg.get("tags") or ()))
    if lead:
        save_composed_config(cfg, trainer.output_dir)
    n_train = count_params(p for p in model.parameters() if p.requires_grad)
    n_total = count_params(model.parameters())
    if lead:
        trainer.metrics_log.log_hyperparams(cfg, {
            "model/params/total": n_total,
            "model/params/trainable": n_train,
            "model/params/non_trainable": n_total - n_train,
        })

    result: dict[str, Any] = {}
    if cfg.get("train", True):
        # a tag ("last" / "best") or a checkpoints directory
        resume_from = cfg.get("ckpt_path")
        if cfg.get("profile") and lead:
            # reference debug/profiler.yaml: a profiler trace of the fit
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=activities) as prof:
                state = trainer.fit(state, loaders["train"], loaders["val"],
                                    resume_from=resume_from)
            trace = trainer.output_dir / "profile" / "trace.json"
            trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace))
            # the program's spans and counters beside the trace
            (trace.parent / "spans.json").write_text(
                json.dumps(profiling.snapshot()))
        else:
            state = trainer.fit(state, loaders["train"], loaders["val"],
                                resume_from=resume_from)
        # the last validation's metrics, as the reference's train returns
        # Lightning's callback_metrics: the hparams search reads its
        # optimized_metric (val_loss) here
        result.update(trainer.val_metrics)
    if cfg.get("test", True):
        result.update(trainer.test(state, loaders["test"]))
    if cfg.get("predict", False):
        # every data rank writes the masks of its shard of the test set (the
        # names are the dataset's, so one directory gathers them all)
        out_dir = Path(cfg["paths"]["output_dir"]) / "output_masks"
        trainer.predict(state, loaders["test"], save_dir=out_dir)
        result["output_masks_dir"] = str(out_dir)
    if cfg.get("export_dir"):
        graph = export_serving(cfg, task, state, loaders["test"], device,
                               tokenizer, pretrained)
        if graph is not None:
            result["export_dir"] = graph
    log.info(f"done: {result}")
    return result


def export_serving(cfg: dict, task: SegmentationTask, state, loader,
                   device: torch.device, tokenizer=None,
                   pretrained=None) -> Optional[str]:
    """`export_dir`: the inference step exported for serving
    (`export_task`) at the shapes of the loader's first batch, for
    `export_platforms` (default: the run's device). The program takes the
    weights as arguments and holds none, so the checkpoint the run wrote
    serves with it (`Trainer.test` restoring the best weights into the
    model first changes nothing in it). Every rank calls it; where the
    run's model is sharded, the task is built again from the config, the
    tokenizer and `load_pretrained`'s result as the run built it. Returns
    the directory on global rank 0, None on the other ranks."""
    from tunevlseg_torch.data.pipeline import device_batch
    sample = (device_batch(next(iter(loader)), device)
              if distributed.rank() == 0 else None)
    graph = export_task(
        task, state, sample, cfg["export_dir"],
        platforms=tuple(cfg.get("export_platforms") or ()) or (device.type,),
        rebuild=lambda: build_model_and_task(cfg, tokenizer, pretrained=pretrained,
                                             device=device)[1])
    if graph is None:
        return None
    log.info(f"exported serving program: {graph}")
    return str(graph.parent)


def export_task(task: SegmentationTask, state, sample: Optional[dict], out_dir,
                platforms: tuple, rebuild=None) -> Optional[Path]:
    """`serving.export_task_predict` of the run's task on any rank grid, at
    the shapes of `sample` (global rank 0's; the other ranks may pass None).
    Returns the first program's path on global rank 0, None elsewhere.

    The program is traced on the whole, unsharded model. On one process and
    under DDP the run's model is that model: rank 0 exports it and the other
    ranks return at once. Under tensor parallelism or FSDP it is sliced and
    sharded, and every rank must call: the run's whole tensors are gathered
    (`checkpoint.whole_tensors`, collectives over the model and the data
    group; the BatchNorm statistics of `state.model_state` over the
    model's), global rank 0 builds the task again through `rebuild()`
    (nothing sharded, on its own device), loads them into its model, which
    checks every name and shape against the run's, and exports that; every
    rank then waits at a barrier until the program is written."""
    from tunevlseg_torch import serving
    from tunevlseg_torch.parallel import data_parallel
    from tunevlseg_torch.training.checkpoint import whole_tensors
    from tunevlseg_torch.training.task import load_partial_state
    lead = distributed.rank() == 0
    sharded = (bool(getattr(task.model, "tp_plan", None))
               or data_parallel.is_sharded(task.model))
    if not sharded:
        return (serving.export_task_predict(task, state, sample, out_dir,
                                            platforms=platforms)
                if lead else None)
    whole = whole_tensors(task.model, dict(task.model.state_dict()))
    whole.update(state.model_state)
    try:
        if not lead:
            return None
        fresh = rebuild()
        load_partial_state(fresh.model, whole)
        del whole
        return serving.export_task_predict(fresh, dict(fresh.model.state_dict()),
                                           sample, out_dir, platforms=platforms)
    finally:
        distributed.barrier()


if __name__ == "__main__":
    main()
