"""The federated-learning server loop of the port: the counterpart of the
repository's ``federated_main.py`` (reference federated_main.py: argparse
flags :791-871, config assembly :60-153, server-loop branches :221-773).

    python -m fairfedmed_tpu_torch.federated_main --model FedOTPLoRA \\
        --trainer GLP_OT_SVLoRA ... [KEY VALUE ...]

Config overrides (``KEY VALUE`` pairs, as yacs takes them) come after every
flag.

One process simulates server and clients: each round loads per-client
weights into the shared trainer, runs the local epochs, harvests the
trainable state and aggregates.  Every sequential branch of the JAX CLI is
here: CLIP zero-shot evaluation, fedavg, fedprox, PromptFL/FedOTP (global
prompt rows averaged, local rows kept per client), FedOTPLoRA (FairLoRA
with group singular values and EMA), FedOTPLinearFT and local.  With
``--parallel_clients`` (the launchers' default) every branch but CLIP runs
the client-parallel rounds of ``fed/parallel_driver.py`` instead: per-client
state on the device, one blocking fetch per round.  Their round-state
checkpoints (``--resume``) and the ``Baseline`` trainer are not ported and
raise.  The flags, their defaults and the printed lines are the JAX CLI's.

``main`` runs on ``cuda`` and raises when no GPU is present; the override
``USE_CUDA False`` (or ``main(args, device="cpu")``) runs the plain PyTorch
paths on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time

import numpy as np
import torch

from .config import CfgNode as CN
from .config import get_cfg_default
from .core.device import resolve_device
from .fed.aggregate import average_weights, average_weights_ema
from .fed.parallel_driver import ParallelRoundRunner
from .fed.sampler import sample_clients
from .train.engine import build_trainer
from .utils.logger import setup_logger
from .utils.tools import count_parameters, set_random_seed

MODELS = ("fedavg", "fedprox", "PromptFL", "FedOTP", "FedOTPLoRA", "FedOTPLinearFT", "local")


def extend_cfg(cfg, args):
    """Add method/dataset config nodes (federated_main.py:60-127)."""
    cfg.TRAINER.PROMPTFL = CN()
    cfg.TRAINER.PROMPTFL.N_CTX = args.n_ctx
    cfg.TRAINER.PROMPTFL.CSC = False
    cfg.TRAINER.PROMPTFL.CTX_INIT = args.ctx_init
    cfg.TRAINER.PROMPTFL.PREC = "fp16"
    cfg.TRAINER.PROMPTFL.CLASS_TOKEN_POSITION = "end"
    # re-declared: the fresh CN() above would otherwise drop this default and
    # make the opt-out unreachable from --opts and config files
    cfg.TRAINER.PROMPTFL.NORMALIZE_MEDICAL_INPUT = False

    cfg.TRAINER.GLP_OT = CN()
    cfg.TRAINER.GLP_OT.N_CTX = args.n_ctx
    cfg.TRAINER.GLP_OT.CSC = False
    cfg.TRAINER.GLP_OT.CTX_INIT = args.ctx_init
    cfg.TRAINER.GLP_OT.PREC = "fp16"
    cfg.TRAINER.GLP_OT.CLASS_TOKEN_POSITION = "end"
    cfg.TRAINER.GLP_OT.N = args.num_prompt
    cfg.TRAINER.GLP_OT.THRESH = args.thresh
    cfg.TRAINER.GLP_OT.EPS = args.eps
    cfg.TRAINER.GLP_OT.OT = args.OT
    cfg.TRAINER.GLP_OT.TOP_PERCENT = args.top_percent
    cfg.TRAINER.GLP_OT.MAX_ITER = args.max_iter

    cfg.TRAINER.GLP_OT_LORA = CN()
    cfg.TRAINER.GLP_OT_LORA.UNFREEZE_IMAGE_ENCODER = args.unfreeze_image_encoder
    cfg.TRAINER.GLP_OT_LORA.UNFREEZE_TEXT_ENCODER = args.unfreeze_text_encoder
    cfg.TRAINER.GLP_OT_LORA.RANK = args.lora_rank
    cfg.TRAINER.GLP_OT_LORA.ALPHA = args.lora_alpha
    cfg.TRAINER.GLP_OT_LORA.TYPE = args.lora_type
    cfg.TRAINER.GLP_OT_LORA.LOCAL_S = args.lora_local_s
    cfg.TRAINER.GLP_OT_LORA.GLOBAL_S = args.lora_global_s
    cfg.TRAINER.LAMBDA_FAIRNESS = args.lambda_fairness
    cfg.TRAINER.GLP_OT_LORA.DISABLE_ATTR = args.disable_attr
    # the intended (differentiable) fairness regulariser; the reference's is
    # detached, and the default keeps that
    cfg.TRAINER.GLP_OT_LORA.DIFFERENTIABLE_FAIRNESS = bool(
        getattr(args, "differentiable_fairness", False))
    # the intended (differentiable) FedProx proximal term (promptfl.py:290-293)
    cfg.TRAINER.DIFFERENTIABLE_FEDPROX = bool(getattr(args, "differentiable_fedprox", False))
    # one optimizer step per batch; the reference steps both registered model
    # names through one shared optimizer (Dassl trainer.py:333-342), and the
    # default keeps that double step
    cfg.TRAINER.GLP_OT_LORA.SINGLE_OPT_STEP = bool(getattr(args, "single_opt_step", False))

    cfg.DATASET.SUBSAMPLE_CLASSES = "all"
    cfg.DATASET.USERS = args.num_users
    cfg.DATASET.IID = args.iid
    cfg.DATASET.PARTITION = args.partition
    cfg.DATASET.USEALL = args.useall
    cfg.DATASET.NUM_SHOTS = args.num_shots
    cfg.DATASET.BETA = args.beta
    cfg.DATASET.REPEATRATE = 0.0
    cfg.DATALOADER.TRAIN_X.N_DOMAIN = args.num_domain
    cfg.DATASET.IMBALANCE_TRAIN = args.imbalance_train
    cfg.DATASET.SPLIT_CLIENT = args.split_client
    cfg.DATASET.ATTRIBUTE_TYPE = args.attribute_type
    cfg.DATASET.ATTRIBUTES = args.attributes
    cfg.DATASET.MODALITY_TYPE = args.modality_type
    cfg.DATASET.DIM_PER_3D_SLICE = args.dim_per_3d_slice
    cfg.OPTIM.ROUND = args.round
    cfg.OPTIM.MAX_EPOCH = 1  # local epochs per round
    cfg.OPTIM.GAMMA = args.gamma
    cfg.OPTIM.LR = args.lr

    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.DATASET.DISEASE_TYPE = args.disease_type
    # client-parallel rounds (fed/parallel_driver.py)
    cfg.TRAIN.PARALLEL_CLIENTS = bool(getattr(args, "parallel_clients", False))


def reset_cfg(cfg, args):
    if args.root:
        cfg.DATASET.ROOT = args.root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.resume:
        cfg.RESUME = args.resume
    if args.seed is not None:
        cfg.SEED = args.seed
    if args.transforms:
        cfg.INPUT.TRANSFORMS = args.transforms
    if args.backbone:
        cfg.MODEL.BACKBONE.NAME = args.backbone
    if args.head:
        cfg.MODEL.HEAD.NAME = args.head
    if args.trainer:
        cfg.TRAINER.NAME = args.trainer
    if args.stepsize > 0:
        cfg.OPTIM.STEPSIZE = (args.stepsize,)
    if args.input_no_transform:
        cfg.INPUT.NO_TRANSFORM = True


def setup_cfg(args):
    cfg = get_cfg_default()
    extend_cfg(cfg, args)
    if args.dataset_config_file:
        cfg.merge_from_file(args.dataset_config_file)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = args.train_batch_size
    cfg.DATALOADER.TEST.BATCH_SIZE = args.test_batch_size
    reset_cfg(cfg, args)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return cfg


def _avg(xs):
    return sum(xs) / len(xs)


def print_args(args, cfg):
    """Startup block: sorted args, the full config, and the versions and
    devices (reference federated_main.py:15-26).  Log harvesters key on the
    ``** Arguments **`` / ``** Config **`` headers."""
    print("***************")
    print("** Arguments **")
    print("***************")
    for key in sorted(args.__dict__):
        print("{}: {}".format(key, args.__dict__[key]))
    print("************")
    print("** Config **")
    print("************")
    print(cfg)
    if torch.cuda.is_available():
        dev_info = f"cuda:{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    else:
        dev_info = "cpu (no CUDA device)"
    print("** System info **")
    print(f"torch: {torch.__version__}  devices: {dev_info}")
    print(f"python: {sys.version.split()[0]}  numpy: {np.__version__}")


def _check_ported(args, cfg):
    """Refuse up front what the port cannot run yet, naming the ROADMAP item."""
    if args.trainer == "Baseline":
        raise NotImplementedError("--trainer Baseline is not ported yet (ROADMAP M17: "
                                  "models/backbones.py)")
    # the CLIP branch evaluates under any --model, as the JAX CLI's loop does
    if args.trainer != "CLIP" and args.model not in MODELS:
        raise NotImplementedError(f"Unknown aggregation model: {args.model}")
    if cfg.TRAIN.PARALLEL_CLIENTS and (args.resume or os.environ.get("FAIRFEDMED_ROUND_CKPT")):
        # the JAX runner saves and restores its round state there; silently
        # writing nothing would advertise a no-op
        raise NotImplementedError("round-state checkpoints (--resume / FAIRFEDMED_ROUND_CKPT) "
                                  "of the --parallel_clients rounds are not ported yet "
                                  "(ROADMAP M18)")


def _pick_users(args, epoch):
    return sample_clients(args.num_users, args.frac, epoch,
                          idxs_users_train=args.idxs_users_train)


def _build_runner(cfg, args, trainer, datanumber_client, datanumber_client_by_attr):
    """The client-parallel runner for ``--parallel_clients`` (JAX
    federated_main.py:223-243), or None with the JAX CLI's notice."""
    supported = (args.model in MODELS and args.trainer != "CLIP"
                 and hasattr(trainer, "make_parallel_local_step"))
    if not supported:
        print("parallel_clients not supported for this model/trainer; "
              "using sequential rounds")
        return None
    try:
        runner = ParallelRoundRunner(trainer, cfg, args, datanumber_client,
                                     datanumber_client_by_attr)
    except NotImplementedError as e:
        print(f"parallel_clients unavailable ({e}); using sequential rounds")
        return None
    print("Client-parallel mesh rounds enabled")
    return runner


def main(args, device=None):
    """Run ``args.round`` federated rounds; returns the per-round
    ``{"acc": [...], "auc": [...], "time": [...]}``.  ``device`` defaults to
    ``cuda`` (``cpu`` when the config sets ``USE_CUDA False``)."""
    args.idxs_users_train = _int_list(args.idxs_users_train)
    args.idxs_users_test = _int_list(args.idxs_users_test)
    cfg = setup_cfg(args)
    if cfg.SEED >= 0:
        set_random_seed(cfg.SEED)
    setup_logger(cfg.OUTPUT_DIR)
    print_args(args, cfg)
    _check_ported(args, cfg)
    device = resolve_device(device if device is not None else "cuda" if cfg.USE_CUDA else "cpu")

    local_weights = [[] for _ in range(args.num_users)]
    local_weights_0 = [[] for _ in range(args.num_users)]
    local_weights_1 = [[] for _ in range(args.num_users)]
    local_weights_per = [{} for _ in range(args.num_users)]

    local_trainer = build_trainer(cfg, device=device)
    local_trainer.fed_before_train()
    named = local_trainer.named_parameters()
    count_parameters(named, "prompt_learner")
    count_parameters(named, "image_encoder")
    count_parameters(named, "text_encoder")

    datanumber_client = []
    datanumber_client_by_attr = [] if not cfg.TRAINER.GLP_OT_LORA.DISABLE_ATTR else None
    if args.trainer != "CLIP":  # CLIP trains nothing and aggregates nothing
        for net_i in range(cfg.DATASET.USERS):
            ds = local_trainer.fed_train_loader_x_dict[net_i].dataset
            datanumber_client.append(len(ds))
            if datanumber_client_by_attr is not None:
                if hasattr(ds, "count_by_attribute") and cfg.DATASET.NAME in ("FairFedMed",
                                                                              "FedChexMimic"):
                    datanumber_client_by_attr.append(ds.count_by_attribute(args.attribute_type))
                else:
                    datanumber_client_by_attr = None
    if datanumber_client_by_attr:
        # clients missing the highest group id give shorter histograms: pad
        # to a common length so the group-weighted average stays rectangular
        width = max(len(c) for c in datanumber_client_by_attr)
        datanumber_client_by_attr = [c + [0] * (width - len(c)) for c in datanumber_client_by_attr]
    global_weights = copy.deepcopy(local_trainer.state_dict())

    # client-parallel rounds: per-client state stays on the device between
    # rounds, and each round ends in one blocking fetch
    runner = None
    if cfg.TRAIN.PARALLEL_CLIENTS:
        runner = _build_runner(cfg, args, local_trainer, datanumber_client,
                               datanumber_client_by_attr)

    max_epoch = cfg.OPTIM.ROUND
    global_test_acc_list, global_test_error_list = [], []
    global_test_f1_list, global_test_auc_list = [], []
    global_epoch_list, global_time_list = [], []
    start = time.time()
    if args.resume and runner is None:
        # round-state checkpoints belong to the client-parallel path; never
        # advertise a no-op
        print(f"WARNING: --resume {args.resume} requires the "
              "--parallel_clients mesh path; no round-state checkpoint will "
              "be written or restored on the sequential loop")

    def summarize(results, epoch, with_auc=True):
        _summarize(results, start, global_time_list, global_test_acc_list,
                   global_test_error_list, global_test_f1_list, global_test_auc_list,
                   global_epoch_list, epoch, with_auc=with_auc)
        _report_split_client(cfg, args, epoch, [r[0] for r in results])

    def evaluate_parallel(eval_idxs, epoch):
        results = runner.parallel_eval(eval_idxs, epoch)
        if results is None:  # no device eval cache: the sequential evaluation
            results = []
            for idx in eval_idxs:
                runner.install_client(idx)
                results.append(local_trainer.test(idx=idx, current_epoch=epoch))
        return results

    # Deferred rounds (client-parallel path): a round's blocking fetch runs
    # after the next round has been enqueued, and the parked flush prints
    # the earlier round's whole block, so stdout keeps the blocking order
    pending_flush = None

    def _defer_round(epoch, handle, pre_lines, post_train_lines, eval_idxs, with_auc=True,
                     skip_eval=False):
        """The resolver that prints one round's block (the sampling line,
        per-client loss lines, evaluation, metric summary) once its results
        are fetched (JAX federated_main.py:273-306)."""
        eval_idxs = [int(i) for i in eval_idxs]

        def _flush():
            for line in pre_lines:
                print(line)
            runner.resolve_round(handle)
            print("------------local train finish epoch:", epoch, "-------------")
            for line in post_train_lines:
                print(line)
            if skip_eval:
                print("Epoch on server :", epoch)
                return
            print("------------local test start-------------")
            summarize(evaluate_parallel(eval_idxs, epoch), epoch, with_auc=with_auc)
            print("Epoch on server :", epoch)
            print()
        return _flush

    def _schedule_flush(flush, defer_ok):
        """Resolve the parked flush, then park this round's, or resolve it
        now when its evaluation needs this round's state on the host path."""
        nonlocal pending_flush
        prev, pending_flush = pending_flush, None
        if prev is not None:
            prev()
        if defer_ok:
            pending_flush = flush
        else:
            flush()

    def run_parallel(epoch, idxs_users, mode, pre_lines, post_train_lines, eval_idxs,
                     with_auc=True, skip_eval=False, test_users=None, fedprox_mu=None):
        handle = runner.run_round(epoch, list(idxs_users), max_epoch, mode=mode,
                                  test_users=test_users, fedprox_mu=fedprox_mu,
                                  eval_users=None if skip_eval else eval_idxs, deferred=True)
        flush = _defer_round(epoch, handle, pre_lines, post_train_lines, eval_idxs,
                             with_auc=with_auc, skip_eval=skip_eval)
        _schedule_flush(flush, skip_eval or handle["pending_eval"] is not None)

    try:
        for epoch in range(max_epoch):
            train_start = f"------------local train start epoch: {epoch} -------------"
            if args.trainer == "CLIP":
                # zero-shot evaluation, one round (federated_main.py:223-267)
                print("------------local test start-------------")
                m = max(int(args.frac * args.num_users), 1)
                idxs_users = np.random.choice(range(args.num_users), m, replace=False)
                results = []
                for idx in idxs_users:
                    local_trainer.load_state_dict(global_weights)
                    results.append(local_trainer.test(idx=int(idx), current_epoch=epoch))
                summarize(results, epoch, with_auc=False)
                print("------------local test finish-------------")
                break

            elif args.model in ("fedavg", "fedprox"):
                # FedAvg over the whole trainable state; fedprox adds the
                # proximal term towards the round's global weights and
                # evaluates only the round's users (federated_main.py:269-382)
                fedprox = args.model == "fedprox"
                m = max(int(args.frac * args.num_users), 1)
                idxs_users = np.random.choice(range(args.num_users), m, replace=False)
                eval_idxs = list(idxs_users) if fedprox else list(range(cfg.DATASET.USERS))
                if runner is not None:
                    run_parallel(epoch, idxs_users, "fedavg",
                                 [f"idxs_users {idxs_users}", train_start], [], eval_idxs,
                                 with_auc=False, fedprox_mu=float(args.mu) if fedprox else None)
                    continue
                print("idxs_users", idxs_users)
                print("------------local train start epoch:", epoch, "-------------")
                for idx in idxs_users:
                    local_trainer.load_state_dict(global_weights, strict=False)
                    local_trainer.train(idx=int(idx), global_epoch=epoch, is_fed=True,
                                        global_weight=global_weights if fedprox else None,
                                        fedprox=fedprox, mu=args.mu)
                    local_weights[idx] = copy.deepcopy(local_trainer.state_dict())
                print("------------local train finish epoch:", epoch, "-------------")
                global_weights = average_weights(local_weights, list(idxs_users), datanumber_client)
                print("------------local test start-------------")
                results = []
                for idx in eval_idxs:
                    local_trainer.load_state_dict(global_weights, strict=False)
                    results.append(local_trainer.test(idx=int(idx), current_epoch=epoch))
                summarize(results, epoch, with_auc=False)

            elif args.model in ("PromptFL", "FedOTP"):
                # the first avg_prompt prompt rows averaged, the rest kept per
                # client (federated_main.py:384-485)
                if epoch == 0:
                    idxs_users = list(range(cfg.DATASET.USERS))
                else:
                    m = max(int(args.frac * args.num_users), 1)
                    idxs_users = list(np.random.choice(range(args.num_users), m, replace=False))
                if runner is not None:
                    run_parallel(epoch, idxs_users, "prompt_personal",
                                 [f"idxs_users {idxs_users}", train_start], [],
                                 list(range(cfg.DATASET.USERS)))
                    continue
                print("idxs_users", idxs_users)
                print("------------local train start epoch:", epoch, "-------------")
                for idx in idxs_users:
                    if epoch == 0:
                        local_trainer.load_state_dict(global_weights, strict=False)
                    else:
                        local_trainer.load_state_dict(local_weights_per[idx], strict=False)
                    local_trainer.train(idx=int(idx), global_epoch=epoch, is_fed=True)
                    ctx = local_trainer.state_dict()["prompt_learner.ctx"]
                    local_weights_0[idx] = ctx[:args.avg_prompt].copy()
                    local_weights_1[idx] = ctx[args.avg_prompt:args.num_prompt].copy()
                print("------------local train finish epoch:", epoch, "-------------")
                global_prompt = average_weights(local_weights_0, idxs_users, datanumber_client,
                                                islist=True)
                print("------------local test start-------------")
                results = []
                for idx in range(cfg.DATASET.USERS):
                    local_weights_per[idx]["prompt_learner.ctx"] = np.concatenate(
                        [global_prompt, local_weights_1[idx]], axis=0
                    ) if len(local_weights_1[idx]) else global_prompt
                for idx in range(cfg.DATASET.USERS):
                    local_trainer.load_state_dict(local_weights_per[idx], strict=False)
                    results.append(local_trainer.test(idx=idx, current_epoch=epoch))
                summarize(results, epoch)

            elif args.model == "FedOTPLoRA":
                # FairLoRA: global+local prompts, LoRA on the image encoder, EMA
                # aggregation with group-weighted lora_S (federated_main.py:604-726)
                idxs_users = _pick_users(args, epoch)
                # large-scale eval gating (reference federated_main.py:654-676):
                # with >= 50 users, per-round testing starts only at epoch 140
                skip_eval = args.num_users >= 50 and epoch < 140
                all_users = args.idxs_users_test or list(range(cfg.DATASET.USERS))
                if runner is not None:
                    run_parallel(epoch, idxs_users, "ema_personal", [train_start], ["Use EMA"],
                                 all_users, skip_eval=skip_eval, test_users=all_users)
                    continue
                print("------------local train start epoch:", epoch, "-------------")
                for idx in idxs_users:
                    if epoch == 0:
                        local_trainer.load_state_dict(global_weights, strict=False)
                    else:
                        local_trainer.load_state_dict(local_weights_per[idx], strict=False)
                    local_trainer.train(idx=int(idx), global_epoch=epoch, is_fed=True,
                                        is_last_client=idx == idxs_users[-1])
                    local_weight = local_trainer.state_dict()
                    local_weights_0[idx] = local_weight["prompt_learner.ctx"][args.avg_prompt:args.num_prompt].copy()
                    local_weights_1[idx] = {k: v.copy() for k, v in local_weight.items() if "lora_S" in k}
                    local_weights[idx] = copy.deepcopy(local_weight)
                print("------------local train finish epoch:", epoch, "-------------")

                print("Use EMA")
                global_weights = average_weights_ema(
                    global_weights, local_weights, idxs_users, datanumber_client,
                    datanumber_client_by_attr, epoch, max_epoch, shared_half_s=args.shared_half_s)

                print("------------local test start-------------")
                results = []
                for idx in all_users:
                    local_weights_per[idx] = copy.deepcopy(global_weights)
                    if idx in args.idxs_users_train:
                        # local embeddings are kept only for explicitly listed
                        # training users (reference federated_main.py:648-652)
                        local_weights_per[idx]["prompt_learner.ctx"][args.avg_prompt:args.num_prompt] = local_weights_0[idx]
                        if cfg.TRAINER.GLP_OT_LORA.LOCAL_S:
                            for k, v in local_weights_1[idx].items():
                                local_weights_per[idx][k] = v
                if skip_eval:
                    print("Epoch on server :", epoch)
                    continue
                for idx in all_users:
                    local_trainer.load_state_dict(local_weights_per[idx], strict=False)
                    results.append(local_trainer.test(idx=int(idx), current_epoch=epoch))
                summarize(results, epoch)

            elif args.model == "FedOTPLinearFT":
                # global+local prompts, LoRA on the image encoder, plain FedAvg
                # over the full state; local prompt rows and local lora_S kept per
                # client (federated_main.py:487-602)
                idxs_users = _pick_users(args, epoch)
                all_users = args.idxs_users_test or list(range(cfg.DATASET.USERS))
                if runner is not None:
                    run_parallel(epoch, idxs_users, "fedavg_personal", [train_start], [],
                                 all_users, test_users=all_users)
                    continue
                print("------------local train start epoch:", epoch, "-------------")
                for idx in idxs_users:
                    if epoch == 0:
                        local_trainer.load_state_dict(global_weights, strict=False)
                    else:
                        local_trainer.load_state_dict(local_weights_per[idx], strict=False)
                    local_trainer.train(idx=int(idx), global_epoch=epoch, is_fed=True)
                    local_weight = local_trainer.state_dict()
                    local_weights_0[idx] = local_weight["prompt_learner.ctx"][args.avg_prompt:args.num_prompt].copy()
                    local_weights_1[idx] = {k: v.copy() for k, v in local_weight.items() if "lora_S" in k}
                    local_weights[idx] = copy.deepcopy(local_weight)
                print("------------local train finish epoch:", epoch, "-------------")
                global_weights = average_weights(local_weights, list(idxs_users), datanumber_client)
                print("------------local test start-------------")
                results = []
                for idx in all_users:
                    local_weights_per[idx] = copy.deepcopy(global_weights)
                    # a client never trained (restricted --idxs_users_train) has
                    # no local rows yet: it keeps the global ones
                    if len(local_weights_0[idx]) > 0:
                        local_weights_per[idx]["prompt_learner.ctx"][args.avg_prompt:args.num_prompt] = local_weights_0[idx]
                    if cfg.TRAINER.GLP_OT_LORA.LOCAL_S and local_weights_1[idx]:
                        for k, v in local_weights_1[idx].items():
                            local_weights_per[idx][k] = v
                for idx in all_users:
                    local_trainer.load_state_dict(local_weights_per[idx], strict=False)
                    results.append(local_trainer.test(idx=int(idx), current_epoch=epoch))
                summarize(results, epoch)

            else:  # local: no aggregation, a single round (federated_main.py:728-773)
                m = max(int(args.frac * args.num_users), 1)
                idxs_users = np.random.choice(range(args.num_users), m, replace=False)
                print("idxs_users", idxs_users)
                print("------------local train start epoch:", epoch, "-------------")
                results = []
                if runner is not None:
                    idxs = [int(i) for i in idxs_users]
                    runner.run_round(epoch, idxs, max_epoch, mode="local_personal",
                                     test_users=idxs, eval_users=idxs)
                    results = evaluate_parallel(idxs, epoch)
                else:
                    for idx in idxs_users:
                        local_trainer.load_state_dict(global_weights)
                        local_trainer.train(idx=int(idx), global_epoch=epoch, is_fed=True)
                        results.append(local_trainer.test(idx=int(idx), current_epoch=epoch))
                summarize(results, epoch, with_auc=False)
                break

            print("Epoch on server :", epoch)
            print()
    except BaseException:
        # a failure while round r+1 is enqueued must not lose round r's
        # computed output block: resolve the parked flush, then re-raise
        if pending_flush is not None:
            flush, pending_flush = pending_flush, None
            try:
                flush()
            except Exception as flush_err:
                print(f"deferred round flush failed during error unwind: {flush_err!r}",
                      file=sys.stderr)
        raise

    if pending_flush is not None:  # the last deferred round
        pending_flush()

    # final per-client weights (federated_main.py:775-778); the local branch
    # never fills the personalization store, so it saves the initial weights
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    for idx in range(cfg.DATASET.USERS):
        if runner is not None and args.model != "local":
            state = runner.final_state_dict(idx)
        else:
            state = local_weights_per[idx] if local_weights_per[idx] else global_weights
        path = os.path.join(cfg.OUTPUT_DIR, f"global_client{idx}_final.npz")
        np.savez(path, **{k: np.asarray(v) for k, v in state.items()})

    local_trainer.fed_after_train()
    if global_test_acc_list:
        print(f"maximum test acc: {max(global_test_acc_list)}")
        print(f"mean of acc: {np.mean(global_test_acc_list[-5:])}")
        print(f"std of acc: {np.std(global_test_acc_list[-5:])}")
    return {"acc": global_test_acc_list, "auc": global_test_auc_list, "time": global_time_list}


def _summarize(results, start, time_list, acc_list, err_list, f1_list, auc_list,
               epoch_list, epoch, with_auc=True):
    """Per-round metric block.  ``with_auc`` mirrors the reference's
    per-branch reporting: PromptFL/FedOTP, FedOTPLinearFT and FedOTPLoRA
    print the AUC line; fedavg, fedprox, local and CLIP do not
    (federated_main.py:462, :579, :702)."""
    accs = [r[0] for r in results]
    errs = [r[1] for r in results]
    f1s = [r[2] for r in results]
    aucs = [r[3] for r in results if len(r) > 3] if with_auc else []
    time_list.append(time.time() - start)
    acc_list.append(_avg(accs))
    err_list.append(_avg(errs))
    f1_list.append(_avg(f1s))
    if aucs:
        auc_list.append(_avg(aucs))
    epoch_list.append(epoch)
    print("Global test acc:", _avg(accs))
    print("Global test error:", _avg(errs))
    print("Global test macro_f1:", _avg(f1s))
    if aucs:
        print("Global test auc:", _avg(aucs))
    print("------------local test finish-------------")


# per-domain client blocks for the feature-skew benchmarks
# (federated_main.py:582-599 prints per-domain means when split_client is on)
_DOMAIN_BLOCKS = {
    "DomainNet": (("clipart", 0, 5), ("infograph", 5, 10), ("painting", 10, 15),
                  ("quickdraw", 15, 20), ("real", 20, 25), ("sketch", 25, 30)),
    "Office": (("amazon", 0, 3), ("caltech", 3, 6), ("dslr", 6, 9), ("webcam", 9, 12)),
}


def _report_split_client(cfg, args, epoch, accs):
    blocks = _DOMAIN_BLOCKS.get(cfg.DATASET.NAME)
    if blocks is None or epoch < 5 or not args.split_client:
        return
    print("Test acc of clients:", accs)
    for name, lo, hi in blocks:
        if len(accs) >= hi:
            print(f"Test acc of {name}", np.mean(accs[lo:hi]), "±", np.std(accs[lo:hi]))
    print("Test acc of all", np.mean(accs), np.std(accs))


def _int_list(value):
    """Comma-separated client-id list ("0,1,2" -> [0, 1, 2])."""
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    return [int(v) for v in str(value).split(",") if v.strip() != ""]


def _str2bool(v):
    """Boolean flag parser accepting the reference scripts' 'True'/'False'
    (the reference's ``type=_str2bool`` took any non-empty string as True)."""
    if isinstance(v, bool):
        return v
    low = str(v).strip().lower()
    if low in ("true", "1", "yes"):
        return True
    if low in ("false", "0", "no", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_arg_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="FedOTP", help="aggregation model: FedOTP, fedavg, fedprox, FedOTPLoRA, FedOTPLinearFT, local")
    parser.add_argument("--trainer", type=str, default="GLP_OT", help="CLIP, PromptFL, GLP_OT, GLP_OT_SVLoRA, Baseline")
    parser.add_argument("--round", type=int, default=10, help="number of communication rounds")
    parser.add_argument("--stepsize", type=int, default=-1)
    parser.add_argument("--num_users", type=int, default=10)
    parser.add_argument("--frac", type=float, default=1)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--test_batch_size", type=int, default=100)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--mu", type=float, default=0.5, help="fedprox mu")
    parser.add_argument("--disease_type", type=str, default="heart.attack")
    parser.add_argument("--iid", type=_str2bool, default=False)
    parser.add_argument("--num_shots", type=int, default=2)
    parser.add_argument("--useall", type=_str2bool, default=False)
    parser.add_argument("--partition", type=str, default="noniid-labeldir100")
    parser.add_argument("--beta", type=float, default=0.1)
    parser.add_argument("--imbalance_train", type=_str2bool, default=False)
    parser.add_argument("--split_client", type=_str2bool, default=False)
    parser.add_argument("--num_domain", type=int, default=4)
    parser.add_argument("--attribute_type", type=str, default="race")
    parser.add_argument("--attributes", type=str, nargs="+",
                        default=["gender", "race", "ethnicity", "language", "maritalstatus"])
    parser.add_argument("--modality_type", type=str, default="slo_fundus")
    parser.add_argument("--dim_per_3d_slice", type=int, default=16)
    parser.add_argument("--input_no_transform", type=_str2bool, default=False)
    parser.add_argument("--n_ctx", type=int, default=16)
    parser.add_argument("--num_prompt", type=int, default=2)
    parser.add_argument("--avg_prompt", type=int, default=1)
    parser.add_argument("--ctx_init", default=False)
    parser.add_argument("--OT", type=str, default="COT")
    parser.add_argument("--top_percent", type=float, default=1)
    parser.add_argument("--eps", type=float, default=0.1)
    parser.add_argument("--thresh", type=float, default=1e-3)
    parser.add_argument("--max_iter", type=int, default=100)
    parser.add_argument("--unfreeze_image_encoder", type=_str2bool, default=False)
    parser.add_argument("--unfreeze_text_encoder", type=_str2bool, default=False)
    parser.add_argument("--lora_rank", type=int, default=4)
    parser.add_argument("--lora_alpha", type=float, default=0.04)
    parser.add_argument("--lora_type", type=str, default="LoRA")
    parser.add_argument("--lora_local_s", type=_str2bool, default=False)
    parser.add_argument("--shared_half_s", type=_str2bool, default=False)
    parser.add_argument("--lora_global_s", type=_str2bool, default=False)
    parser.add_argument("--lambda_fairness", type=float, default=0.0)
    parser.add_argument("--differentiable_fairness", action="store_true",
                        help="let the fairness regulariser contribute "
                             "gradients (the reference detaches it)")
    parser.add_argument("--differentiable_fedprox", action="store_true",
                        help="let the FedProx proximal term contribute "
                             "gradients (the reference builds it from "
                             "detached state_dict() tensors, promptfl.py:292)")
    parser.add_argument("--single_opt_step", action="store_true",
                        help="apply ONE optimizer/scheduler step per batch "
                             "(the reference double-steps both through its "
                             "model registry when the image encoder is "
                             "unfrozen, Dassl trainer.py:333-342)")
    # the reference declares these type=list, which turns "0,1" into a
    # character list; they parse comma-separated ints here
    parser.add_argument("--idxs_users_train", type=_int_list, default=[],
                        help="comma-separated client ids to train")
    parser.add_argument("--idxs_users_test", type=_int_list, default=[],
                        help="comma-separated client ids to test")
    parser.add_argument("--disable_attr", action="store_true")
    parser.add_argument("--parallel_clients", action="store_true",
                        help="client-parallel rounds (fed/parallel_driver.py)")
    parser.add_argument("--logdir", type=str, required=False, default="./logs/")
    parser.add_argument("--root", type=str, default="/DATA/")
    parser.add_argument("--output-dir", type=str, default="output/..")
    parser.add_argument("--config-file", type=str, default="configs/trainers/GLP_OT/rn50.yaml")
    parser.add_argument("--dataset-config-file", type=str, default="configs/datasets/caltech101.yaml")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--transforms", type=str, nargs="+")
    parser.add_argument("--backbone", type=str, default="")
    parser.add_argument("--head", type=str, default="")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--model-dir", type=str, default="")
    parser.add_argument("--load-epoch", type=int)
    parser.add_argument("--no-train", action="store_true")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


if __name__ == "__main__":
    args = build_arg_parser().parse_args()
    args.idxs_users_train = [int(i) for i in args.idxs_users_train]
    args.idxs_users_test = [int(i) for i in args.idxs_users_test]
    for idx in args.idxs_users_train:
        assert idx < args.num_users, "idx of users to train must be less than num_users"
    for idx in args.idxs_users_test:
        assert idx < args.num_users, "idx of users to test must be less than num_users"
    print("args.attributes", args.attributes)
    main(args)
