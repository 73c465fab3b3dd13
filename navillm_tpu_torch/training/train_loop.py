"""Training driver: multi-task epochs, validation, checkpoint retention.

Torch twin of navillm_tpu/training/train_loop.py (reference train.py:
33-294):
  - ``build_runner``: the tokenizer and the model on ``args.device``. With
    --pretrained_model_name_or_path, an HF-layout directory: its
    tokenizer.json and its Llama weights (models/convert.py:load_vicuna,
    int8/int4 with --quantize_llm), or, with --from_scratch or
    --resume_from_checkpoint, its config.json's architecture with random
    weights (the checkpoint fills them); the full panorama encoder.
    Without one, the byte tokenizer and the JAX package's tiny
    configuration, on the card widened to what the attention kernels take.
    Random weights come from ``args.seed``;
  - ``build_world_and_data`` / ``build_agents``: the world, the stage's
    loaders (with the view and object feature DBs: ``mp3d``, ``scan_qa``
    and ``coco`` views, REVERIE and SOON objects) and the task agents from
    the config (every task of configs/multi.yaml);
  - ``train_one_epoch``: gradients accumulate in the parameters' .grad
    (runner.zero_grads / take_grads), and every gradient_accumulation_step
    batches one optimizer step applies clip + AdamW (8-bit moments with
    --adam_8bit). The loss of batch N
    is read on the host only after batch N+1 has been dispatched (one-step
    lag), so the card works through N's backward while the host simulates
    N+1;
  - ``val_one_epoch``: streaming validation per navigation task (greedy,
    or sampled under --do_sample; batched, the agent's validate, under
    --no-streaming_eval), ScanQA's generated answers through its agent's
    validate, the predictions gathered (single process) and scored;
  - ``calc_overall_score``: task-weighted SPL model selection;
  - ``run_training``: the epoch loop with best-score checkpoint retention
    (max_saved_checkpoints), pretrain-stage periodic saves, latest-state
    saves and resume (training/checkpoints.py). A flag of a path not
    ported raises (utils/config.check_ported);
  - ``build_mesh_plan``: with more than one process (torchrun, one per
    card) or --tp_size above 1, the (data, model) grid of
    parallel/mesh.py: each rank of a data group reads its own shard of
    every loader (--batch_size is per card), the LLM is split over the
    model group, gradients are averaged over the data group, the moments
    are ZeRO-1 slices (--zero1, the default), validation predictions are
    gathered on rank 0, and rank 0 logs and writes the checkpoints (every
    rank takes part in gathering them).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..agents import load_agent
from ..agents.runner import NavModelRunner
from ..convert import init_nav_params
from ..data.feature_db import create_feature_db, create_object_feature_db
from ..data.loaders import NAME_OF, MetaLoader, create_dataloaders
from ..models import llama as L
from ..models.convert import config_from_hf, load_vicuna, read_hf_config
from ..models.nav_model import NavModel, NavModelConfig
from ..models.pano_encoder import PanoConfig
from ..models.tokenization import NavTokenizer
from ..parallel.dist import (all_gather_objects, init_distributed,
                             merge_dist_results)
from ..parallel.mesh import make_mesh, zero1_shard_opt_state
from ..sim.env import WorldModel
from ..utils.config import check_ported
from .checkpoints import (checkpoint_exists, load_checkpoint,
                          remove_checkpoint, save_checkpoint)
from .optim import make_optimizer


def build_mesh_plan(args, logger=None):
    """The (data, model) grid over the processes (joining torchrun's
    process group first, unless the caller has: it may name the backend
    through parallel.dist.init_distributed); None for one process without
    tensor parallelism. Sets args.rank, world_size, dp_size and tp_size
    from the plan."""
    import torch.distributed as dist
    init_distributed()
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n <= 1 and args.tp_size <= 1:
        return None
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    plan = make_mesh(dp_size=args.dp_size, tp_size=args.tp_size,
                     device=device)
    args.rank, args.world_size = plan.rank, plan.world_size
    args.dp_size, args.tp_size = plan.dp_size, plan.tp_size
    if logger is not None:
        logger.info(plan.describe())
    return plan


def _data_rank(args) -> int:
    """This rank's index in its data group (rank // tp_size)."""
    return args.rank // max(args.tp_size, 1)


def _from_rank0(obj, plan):
    """Rank 0's ``obj`` on every rank (one process: obj)."""
    if plan is None:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _dedupe(preds):
    """The merged predictions with each episode once (the loaders pad
    every rank's shard to one length by repeating episodes)."""
    seen, out = set(), []
    for p in preds:
        key = p.get("instr_id") if isinstance(p, dict) else None
        if key is not None:
            if key in seen:
                continue
            seen.add(key)
        out.append(p)
    return out


class Metrics:
    """Running averager (reference train.py:17-30)."""

    def __init__(self):
        self.num = 0
        self.total = 0.0

    def accumulate(self, x):
        self.num += 1
        self.total += float(x)

    @property
    def average(self):
        return self.total / self.num if self.num else 0.0


def make_opt_step(tx):
    """One optimizer update from a {name: gradient} dict; updates the
    parameters and moments in place (the JAX step donates them) and
    returns the pre-clip global gradient norm as a device scalar."""
    def opt_step(grads):
        return tx.step(grads)
    return opt_step


def train_one_epoch(args, cfg, runner, tx, opt_step, meta_loader, agents,
                    datasets, epoch, logger, num_batches):
    """Returns (average loss, pre-clip gradient norms of the optimizer
    steps as device scalars)."""
    stage_cfg = cfg.Pretrain if args.stage == "pretrain" else cfg.Multi
    loss_metric = Metrics()
    loss_stats = {k: Metrics() for k in stage_cfg.SOURCE}
    grad_norms = []

    runner.zero_grads()
    pending = None

    def drain(pending):
        if pending is not None:
            pname, ploss = pending
            ploss = float(ploss)
            loss_metric.accumulate(ploss)
            loss_stats[pname].accumulate(ploss)

    for step, (name, batch) in enumerate(meta_loader):
        agent = agents[name]
        loss = agent.train(name, batch, args, cfg, dataset=datasets.get(name),
                           step=step)
        drain(pending)
        pending = (name, loss)

        if (step + 1) % args.gradient_accumulation_step == 0:
            grad_norms.append(opt_step(runner.take_grads()))
            runner.zero_grads()

        if logger is not None and args.rank == 0 and (step + 1) % 100 == 0:
            logger.info("epoch %d step %d/%d [%s] loss=%.4f"
                        % (epoch, step + 1, num_batches, name,
                           loss_metric.average))

        if step == num_batches - 1:
            drain(pending)
            pending = None
            if logger is not None:
                msg = "***** train [%d] epoch *****\nLoss: %.4f\n" \
                    % (epoch, loss_metric.average)
                for task in stage_cfg.SOURCE:
                    msg += "%s: %.4f\n" % (task, loss_stats[task].average)
                logger.info(msg)
            break
    drain(pending)
    return loss_metric.average, grad_norms


def tiny_config(args, vocab_size: int, device) -> NavModelConfig:
    """The model built without a pretrained path. On the CPU it is the JAX
    package's tiny configuration (2-layer f32 LLM, hidden 128 over 4 heads,
    tiny panorama encoder, its object branch with --enable_og), f32
    whatever --precision says, as in JAX; --fuse_obj fuses the objects into
    the encoder with --enable_og (the JAX package reads it only on its
    pretrained path, where full_config takes it as given). On
    the card every LLM layer runs through the attention kernels, which take
    bf16 and head_dim 64 or 128 (ops/attention.py), so there the LLM is
    hidden 256 over 4 heads (head_dim 64, MLP 512) and the LLM and the
    panorama encoder are bf16; --precision fp32 raises there."""
    llm_kw, pano_kw = {}, {}
    if torch.device(device).type == "cuda":
        if args.precision != "bf16":
            raise ValueError(f"--precision {args.precision}: the attention "
                             f"kernels run bf16 only; train in f32 on the "
                             f"CPU (--device cpu)")
        llm_kw = dict(hidden_size=256, intermediate_size=512,
                      dtype=torch.bfloat16)
        pano_kw = dict(dtype=torch.bfloat16)
    llm_cfg = L.LlamaConfig.tiny(vocab_size=vocab_size, **llm_kw)
    pano_cfg = PanoConfig.tiny(output_size=llm_cfg.hidden_size,
                               use_obj=args.enable_og,
                               fuse_obj=args.enable_og and args.fuse_obj,
                               **pano_kw)
    return NavModelConfig(llm=llm_cfg, pano=pano_cfg,
                          angle_feat_size=args.angle_feat_size)


def full_config(args, llm_cfg: L.LlamaConfig) -> NavModelConfig:
    """The pretrained path's model (JAX build_runner): the LLM of the
    checkpoint and the full panorama encoder, its object branch with
    --enable_og and --fuse_obj as given, in the dtype of --precision."""
    pano_cfg = PanoConfig(
        image_feat_size=args.image_feat_size,
        obj_feat_size=args.obj_feat_size,
        angle_feat_size=args.angle_feat_size,
        num_pano_layers=args.num_pano_layers,
        output_size=llm_cfg.hidden_size,
        use_obj=args.enable_og,
        fuse_obj=args.fuse_obj,
        dtype=llm_cfg.dtype)
    return NavModelConfig(llm=llm_cfg, pano=pano_cfg,
                          angle_feat_size=args.angle_feat_size)


def build_runner(args, cfg, logger=None, mesh_plan=None) -> NavModelRunner:
    """Tokenizer + model on ``args.device`` (a plan's device under one).
    With a pretrained path: its tokenizer and its weights (or, with
    --from_scratch or --resume_from_checkpoint, its architecture with
    random weights) and full_config; without one, the byte tokenizer and
    tiny_config. Random weights come from ``args.seed`` (every rank draws
    the same tree and keeps its shards); dropout from args.seed plus the
    data-group rank."""
    if args.quantize_llm and args.mode != "test":
        raise ValueError("--quantize_llm is eval-only: int8 weights are "
                         "not differentiable (models/quant.py)")
    if args.act_int8 and not args.quantize_llm:
        raise ValueError("--act_int8 needs --quantize_llm: int8 "
                         "activations run against quantized weights "
                         "(models/llama.py:_mm)")
    device = mesh_plan.device if mesh_plan is not None \
        else torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card; "
                           "pass --device cpu to run on the CPU")
    llm_params = None
    path = args.pretrained_model_name_or_path
    if path:
        if device.type == "cuda" and args.precision != "bf16":
            raise ValueError(f"--precision {args.precision}: the attention "
                             f"kernels run bf16 only; run f32 on the CPU "
                             f"(--device cpu)")
        dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
        tok = NavTokenizer.from_pretrained(path)
        if args.from_scratch or args.resume_from_checkpoint:
            # the architecture only; the checkpoint fills the weights
            llm_cfg = config_from_hf(read_hf_config(path),
                                     vocab_size=tok.vocab_size, dtype=dtype)
        else:
            llm_cfg, llm_params = load_vicuna(
                path, tok.vocab_size, dtype=dtype,
                quantize=args.quantize_llm, quant_bits=args.quant_bits,
                device=device)
        nav_cfg = full_config(args, llm_cfg)
    else:
        tok = NavTokenizer()
        nav_cfg = tiny_config(args, tok.vocab_size, device)
    if args.act_int8:
        nav_cfg = dataclasses.replace(nav_cfg, llm=dataclasses.replace(
            nav_cfg.llm, act_int8=True))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # --quantize_llm without a pretrained path draws the LLM already
    # quantized (models/quant.py:init_params_quantized); the JAX package
    # runs a dense tree there
    model = NavModel(nav_cfg, init_nav_params(
        nav_cfg, gen, device=device, llm=llm_params,
        quantize_llm=args.quantize_llm and not path,
        quant_bits=args.quant_bits))
    if logger is not None:
        n = sum(p.numel() for p in model.parameters())
        logger.info("model initialized with %.2f M parameters" % (n / 1e6))
    return NavModelRunner(nav_cfg, model, tok, device=device,
                          feat_dropout=args.feat_dropout,
                          ignore_id=args.ignoreid,
                          seed=args.seed + _data_rank(args),
                          kv_int8=args.kv_int8, mesh_plan=mesh_plan)


def build_world_and_data(args, cfg, training: bool, stage: str, world=None,
                         feat_dbs=None, obj_feat_dbs=None, logger=None,
                         test_datasets=None):
    """(world, loaders, datasets, feat_dbs, obj_feat_dbs). Feature DBs are
    injected or built from the config's feature_database (HDF5, read at
    first use), object DBs from its object_database (LMDB, opened when
    built: the lmdb and msgpack packages must be there)."""
    if feat_dbs is None and "feature_database" in cfg.get("Feature", {}):
        feat_dbs = create_feature_db(cfg.Feature.feature_database,
                                     cfg.Feature.image_feat_size,
                                     args.data_dir)
    if obj_feat_dbs is None and "object_database" in cfg.get("Feature", {}):
        obj_feat_dbs = create_object_feature_db(cfg.Feature.object_database,
                                                cfg.Feature.obj_feat_size,
                                                args.data_dir)
    world = world or WorldModel(str(Path(args.data_dir) / "connectivity"))
    loaders, datasets = create_dataloaders(
        args, cfg, training=training, world=world, feat_dbs=feat_dbs,
        obj_feat_dbs=obj_feat_dbs, stage=stage, logger=logger,
        test_datasets=test_datasets)
    return world, loaders, datasets, feat_dbs, obj_feat_dbs


def build_agents(args, sources, world, runner) -> Dict[str, Any]:
    return {src: load_agent(NAME_OF[src], args, world, runner)
            for src in sources}


def val_one_epoch(args, cfg, runner, val_loaders, agents, datasets, epoch,
                  logger) -> Dict[str, Dict[str, float]]:
    """Per task: streaming validation, or with --no-streaming_eval (and for
    the 3D-QA agent, which has no streaming) the agent's validate;
    predictions gathered over the data group (each model group validated
    one shard), each episode once, scored on rank 0 (and saved with
    save_pred_results)."""
    plan = getattr(runner, "plan", None)
    task_results: Dict[str, Dict[str, float]] = {}
    for name, (loader, _ratio) in val_loaders.items():
        if logger is not None:
            logger.info("***** validate %s split on %s task *****"
                        % (args.validation_split, name))
        agent = agents[name]
        validate = agent.validate_streaming if args.streaming_eval and \
            hasattr(agent, "validate_streaming") else agent.validate
        preds = validate(name, args, cfg, loader, dataset=datasets[name])
        all_preds = _dedupe(merge_dist_results(all_gather_objects(
            preds, plan.data if plan is not None else None)))
        if args.rank == 0 and not args.validation_split.startswith("test"):
            score_summary, item_metrics = datasets[name].eval_metrics(
                all_preds, logger=logger, name=name)
            task_results[name] = score_summary
            if logger is not None:
                logger.info("[Eval] dataset=[%s] %s" % (name, {
                    k: round(float(v), 2) for k, v in score_summary.items()}))
            if args.save_pred_results:
                datasets[name].save_json(
                    all_preds,
                    os.path.join(args.output_dir,
                                 f"{name}_{args.validation_split}.json"),
                    item_metrics=item_metrics if args.save_detail_results
                    else None)
    return task_results


def calc_overall_score(results, cfg) -> float:
    """Normalized-SPL sum over R2R/REVERIE/SOON (train.py:184-204)."""
    score = 0.0
    for task in results:
        if task not in cfg.Multi.SOURCE:
            continue
        if task == "R2R":
            score += results[task]["spl"] / 60
        elif task == "REVERIE":
            score += results[task]["spl"] / 36.63
        elif task == "SOON":
            score += results[task]["spl"] / 26.58
        elif task in ("CVDN", "EQA", "ScanQA", "LLaVA"):
            pass
        else:
            raise NotImplementedError(task)
    return score


def run_training(args, cfg, logger=None, world=None, feat_dbs=None,
                 obj_feat_dbs=None, runner=None):
    """The main() flow (reference train.py:207-294). ``world``,
    ``feat_dbs`` and ``runner`` are injectable (an injected runner brings
    its own plan). Returns the best epoch's validation results (mode
    "test": that one validation's; None on ranks other than 0)."""
    check_ported(args)
    plan = build_mesh_plan(args, logger) if runner is None \
        else runner.plan
    if plan is not None:
        args.rank, args.world_size = plan.rank, plan.world_size
        args.dp_size, args.tp_size = plan.dp_size, plan.tp_size
    # the ranks of a model group make the same host decisions
    np.random.seed(args.seed + _data_rank(args))

    world, train_loaders, train_datasets, feat_dbs, obj_feat_dbs = \
        build_world_and_data(args, cfg, training=True, stage=args.stage,
                             world=world, feat_dbs=feat_dbs,
                             obj_feat_dbs=obj_feat_dbs, logger=logger)
    _, val_loaders, val_datasets, _, _ = build_world_and_data(
        args, cfg, training=False, stage="multi", world=world,
        feat_dbs=feat_dbs, obj_feat_dbs=obj_feat_dbs, logger=logger,
        test_datasets=args.test_datasets)

    runner = runner or build_runner(args, cfg, logger, mesh_plan=plan)
    train_agents = build_agents(args, train_loaders.keys(), world, runner)
    val_agents = build_agents(args, val_loaders.keys(), world, runner)

    num_batches = args.num_steps_per_epoch if args.num_steps_per_epoch > 0 \
        else max(len(ld) for ld, _ in train_loaders.values())
    # test mode validates only: no optimizer, so no moments on the card
    tx = None if args.mode == "test" else make_optimizer(
        dict(runner.model.named_parameters()), lr=args.lr,
        num_warmup_steps=max(args.num_warmup_steps //
                             max(args.gradient_accumulation_step, 1), 0),
        grad_clip_norm=args.grad_clip_norm, moments_8bit=args.adam_8bit)
    specs = runner.param_specs
    # the checkpoints' shard layout (one process: none)
    shards = dict(plan=plan, specs=specs) if plan is not None else {}
    if tx is not None and plan is not None:
        tx.set_plan(plan, specs)
        if args.zero1 and plan.dp_size > 1:
            # before a resume, which restores into the slices
            zero1_shard_opt_state(tx, plan)
            if logger is not None:
                logger.info("ZeRO-1: optimizer moments sharded %d-way over "
                            "the data group" % plan.dp_size)

    resume_from_epoch = 0
    if args.resume_from_checkpoint and \
            checkpoint_exists(args.resume_from_checkpoint):
        _, _, resume_from_epoch = load_checkpoint(
            args.resume_from_checkpoint, runner.model, tx, logger, **shards)

    if args.mode == "test":
        return val_one_epoch(args, cfg, runner, val_loaders, val_agents,
                             val_datasets, resume_from_epoch, logger)

    opt_step = make_opt_step(tx)
    meta_loader = MetaLoader(train_loaders, seed=args.seed,
                             off_batch_task=args.off_batch_task,
                             rank=_data_rank(args))
    out = Path(args.output_dir)
    best_results, best_score = None, None
    history_scores = []
    for epoch in range(resume_from_epoch, args.num_epochs):
        train_one_epoch(args, cfg, runner, tx, opt_step, meta_loader,
                        train_agents, train_datasets, epoch, logger,
                        num_batches)
        results = val_one_epoch(args, cfg, runner, val_loaders, val_agents,
                                val_datasets, epoch, logger)
        save_as, remove_epoch = None, None
        if args.rank == 0:
            score = calc_overall_score(results, cfg)
            history_scores.append(score)
            should_save = False
            if best_results is None or score > best_score:
                best_results, best_score = results, score
                should_save = args.max_saved_checkpoints > 0
            if logger is not None:
                logger.info("Current Score: %s | Best Score: %s"
                            % (score, best_score))
            if args.stage == "multi" and should_save:
                if len(history_scores) > args.max_saved_checkpoints:
                    # the worst of the kept epochs goes (history_scores
                    # starts at the resume epoch; JAX takes the index as
                    # the epoch, which only holds without a resume)
                    ranked = sorted(enumerate(history_scores),
                                    key=lambda x: x[1], reverse=True)
                    remove_epoch = resume_from_epoch \
                        + ranked[args.max_saved_checkpoints][0]
                    remove_checkpoint(out / f"epoch_{remove_epoch}")
                save_as = f"epoch_{epoch}"
            elif args.stage == "pretrain" and \
                    (epoch + 1) % args.save_ckpt_per_epochs == 0:
                save_as = f"pretrain_{epoch}"
        # every rank gathers the shards rank 0 writes
        save_as = _from_rank0(save_as, plan)
        if save_as is not None:
            save_checkpoint(out / save_as, runner.model, **shards)
        if args.save_latest_states:
            save_checkpoint(out / "latest", runner.model, tx, epoch,
                            **shards)
    return best_results
