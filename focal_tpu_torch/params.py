"""Recipe loading, device selection, and the arguments of serving and of
training.

A dataset's recipe is ``focal_tpu_torch/configs/{dataset}.yaml``, the
package's own copy of the JAX package's recipe (``load_dataset_config``).
The CLIs resolve it in the JAX CLI's order (``resolve_dataset_yaml``): the
``-dataset_config`` path, then ``./data/{dataset}.yaml`` under the working
directory, then the packaged recipe; a recipe of one's own names one's own
index files.

Training runs one process per card (``parallel.distributed``): the
``-dist_*`` flags or the ``FOCAL_DIST_*`` variables name the process group,
which ``parse_train_params`` joins before any device is chosen; a process's
card is then ``cuda:{local rank % cards}``.
"""

import argparse
import logging
import os

import torch
import yaml

from focal_tpu_torch.parallel.distributed import device_for, maybe_initialize, topology

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

LEARN_FRAMEWORK_REGISTRY = {
    "FOCAL": "contrastive",
    "no": "supervised",
}

DATASET_DEFAULT_TASK = {
    "ACIDS": "vehicle_classification",
    "MOD": "vehicle_classification",
    "RealWorld_HAR": "activity_classification",
    "PAMAP2": "activity_classification",
}


def load_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


def load_dataset_config(dataset):
    """The packaged recipe of a dataset, by name."""
    path = os.path.join(CONFIG_DIR, f"{dataset}.yaml")
    if not os.path.isfile(path):
        known = sorted(f[: -len(".yaml")] for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml"))
        raise FileNotFoundError(f"No recipe for dataset '{dataset}'; packaged recipes: {known}")
    return load_yaml(path)


def resolve_dataset_yaml(dataset, explicit_path=None):
    """The recipe file of a dataset as the CLIs find it, in the JAX CLI's
    order: ``explicit_path`` (-dataset_config), ``./data/{dataset}.yaml``
    under the working directory, the packaged recipe; the first that
    exists."""
    candidates = [explicit_path] if explicit_path else []
    candidates += [os.path.join(".", "data", f"{dataset}.yaml"),
                   os.path.join(CONFIG_DIR, f"{dataset}.yaml")]
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f"No dataset recipe found for '{dataset}'. Looked at: {candidates}")


def cli_dataset_config(args):
    """The recipe of a CLI's ``args`` (resolve_dataset_yaml): the packaged
    one through load_dataset_config, another from its path, logged."""
    path = resolve_dataset_yaml(args.dataset, args.dataset_config_path)
    if os.path.dirname(os.path.abspath(path)) == CONFIG_DIR:
        return load_dataset_config(args.dataset)
    logging.info(f"= Recipe of {args.dataset}: {path}")
    return load_yaml(path)


def default_task(dataset, dataset_config):
    if dataset_config.get("default_task"):
        return dataset_config["default_task"]
    if dataset in DATASET_DEFAULT_TASK:
        return DATASET_DEFAULT_TASK[dataset]
    raise ValueError(f"No default task known for dataset {dataset}; pass -task.")


def get_train_mode(learn_framework):
    if learn_framework not in LEARN_FRAMEWORK_REGISTRY:
        raise ValueError(f"Invalid learn_framework provided: {learn_framework}")
    return LEARN_FRAMEWORK_REGISTRY[learn_framework]


def select_device(device="cuda"):
    """torch.device for ``device`` ("cuda:N" for card N, as -gpu N names
    it). A CUDA device with no card, or an index past the cards, raises:
    the port never carries on on the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' (-device cpu) to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} requested but only {torch.cuda.device_count()} "
                           "CUDA device(s) are visible")
    return dev


def _gpu_device(args):
    """-gpu N: the name of card N for a CUDA -device (cuda:N, which
    select_device then checks); -device cpu ignores it, and says so."""
    if args.gpu is None:
        return args.device
    if torch.device(args.device).type != "cuda":
        logging.info(f"= -gpu {args.gpu} ignored: -device {args.device}")
        return args.device
    return f"cuda:{args.gpu}" if torch.device(args.device).index is None else args.device


def build_parser():
    """The flags of the JAX CLI that serving supports, spelled the same."""
    parser = argparse.ArgumentParser(description="FOCAL (PyTorch/CUDA) batch inference")
    parser.add_argument("-dataset", type=str, default="MOD", help="Dataset recipe name.")
    parser.add_argument("-model", type=str, default="SW_Transformer", help="Backbone.")
    parser.add_argument("-task", type=str, default=None, help="Downstream task.")
    parser.add_argument("-learn_framework", type=str, default="no", help="FOCAL | no.")
    parser.add_argument(
        "-model_weight", type=str, default=None,
        help="Port state_dict (.pt) to serve. Without it the weights are a "
        "seeded random init (-seed), for smoke runs only.",
    )
    parser.add_argument("-batch_size", type=int, default=None, help="Fixed serving batch (128).")
    parser.add_argument(
        "-input", type=str, default=None,
        help="Index file (.txt of sample paths) or directory of .npz/.pt samples.",
    )
    parser.add_argument("-synthetic", action="store_true", help="Serve a synthetic batch.")
    parser.add_argument("-synthetic_samples", type=int, default=512, help="Synthetic sample count.")
    parser.add_argument("-predictions_out", type=str, default=None, help="Predictions JSON path.")
    parser.add_argument("-seed", type=int, default=0, help="Seed for data and random init.")
    parser.add_argument("-pallas_mlp", action="store_true",
                        help="SW_Transformer: run the Swin MLPs through the fused MLP kernel "
                        "(#10; opt-in, as in the JAX CLI).")
    parser.add_argument("-no_pallas_block", action="store_true",
                        help="SW_Transformer: disable the whole-block attention kernels (qkv + "
                        "attention + proj fused per window; #1-#5) and run the attention-only "
                        "kernels (#6-#9) between the qkv and proj Linears, as in the JAX CLI.")
    parser.add_argument("-compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Activation and matmul type on the device (parameters, gradients and "
                        "the optimizer stay float32); bfloat16 runs SW_Transformer's whole-block "
                        "kernels in bf16 (#1-bf16 to #3-bf16) and DeepSense's conv blocks in bf16 "
                        "(with -pallas_conv, #13-bf16/#14-bf16). Default float32, as the JAX "
                        "CLI's off the TPU.")
    parser.add_argument("-device", type=str, default="cuda", help="cuda (default) | cpu.")
    _add_shared_flags(parser)
    return parser


def _add_shared_flags(parser):
    """The flags the serving, training and evaluation CLIs share with the
    JAX CLI's parser: -gpu and -dataset_config."""
    parser.add_argument("-gpu", type=_index, default=None,
                        help="The card to run on: cuda:N (one process; with -device cpu "
                        "ignored). Several processes take one card a rank.")
    parser.add_argument("-dataset_config", dest="dataset_config_path", type=str, default=None,
                        help="Path of the dataset recipe (yaml); else ./data/{dataset}.yaml, else "
                        "the packaged recipe.")


def parse_predict_params(argv=None):
    """Parse serving flags and fill the derived fields (recipe, task, batch)."""
    args = build_parser().parse_args(argv)
    args.device = _gpu_device(args)
    args.dataset_config = cli_dataset_config(args)
    if args.task is None:
        args.task = default_task(args.dataset, args.dataset_config)
    args.train_mode = get_train_mode(args.learn_framework)
    if args.batch_size is None:
        args.batch_size = 128
    return args


def build_train_parser():
    """The JAX CLI's training flags that the port runs, spelled the same."""
    parser = argparse.ArgumentParser(description="FOCAL (PyTorch/CUDA) training")
    parser.add_argument("-dataset", type=str, default="MOD", help="Dataset recipe name.")
    parser.add_argument("-model", type=str, default="SW_Transformer", help="Backbone.")
    parser.add_argument("-task", type=str, default=None, help="Downstream task.")
    parser.add_argument("-learn_framework", type=str, default="FOCAL", help="FOCAL | no.")
    parser.add_argument("-stage", type=str, default="pretrain",
                        help="pretrain | finetune (contrastive only).")
    parser.add_argument("-label_ratio", type=float, default=1.0,
                        help="Share of the train split's labelled samples used by supervised "
                        "training and finetuning.")
    parser.add_argument("-tag", type=str, default=None, help="Run tag; noPrivate changes the loss.")
    parser.add_argument("-batch_size", type=int, default=None,
                        help="Global batch (256 in pretrain, else 128).")
    parser.add_argument("-clip_grad", action="store_true",
                        help="Apply the recipe's clip_grad value (off by default, as in the JAX CLI).")
    parser.add_argument("-epochs", type=int, default=None,
                        help="Number of epochs, instead of the recipe's (also the schedule's length).")
    parser.add_argument("-val_epochs", type=int, default=None,
                        help="Validate after epochs 0, N, 2N, ... and the last (pretrain: 10).")
    parser.add_argument("-synthetic", action="store_true",
                        help="Train on synthetic data shaped like the recipe (no files needed).")
    parser.add_argument("-synthetic_samples", type=int, default=512,
                        help="Synthetic train split size; val and test get a quarter each.")
    parser.add_argument("-seed", type=int, default=0,
                        help="Seed of the init, the data, the schedule and every generator.")
    parser.add_argument("-output_dir", type=str, default=None,
                        help="Root of the weights/ tree (default: the working directory).")
    parser.add_argument("-resume", action="store_true",
                        help="Go on from the _resume checkpoint of -model_weight's folder or of "
                        "the newest matching experiment folder.")
    parser.add_argument("-model_weight", type=str, default=None,
                        help="Experiment folder to resume, to finetune from, or to test.")
    parser.add_argument("-no_fused_views", action="store_true",
                        help="Run the two pretrain views as two forwards, not one [2B] batch.")
    parser.add_argument("-pallas_conv", action="store_true",
                        help="DeepSense: train the conv blocks through the fused conv-tower "
                        "kernels (#13/#14; opt-in, as in the JAX CLI).")
    parser.add_argument("-pallas_mlp", action="store_true",
                        help="SW_Transformer: run the Swin MLPs through the fused MLP kernels "
                        "(#10-#12; opt-in, as in the JAX CLI).")
    parser.add_argument("-no_pallas_block", action="store_true",
                        help="SW_Transformer: disable the whole-block attention kernels (qkv + "
                        "attention + proj fused per window; #1-#5) and run the attention-only "
                        "kernels (#6-#9) between the qkv and proj Linears, as in the JAX CLI.")
    parser.add_argument("-mixup_labels", action="store_true",
                        help="Supervised: train on mixup's soft labels (off by default: the "
                        "reference discards them).")
    parser.add_argument("-compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Activation and matmul type on the device (parameters, gradients and "
                        "the optimizer stay float32); bfloat16 runs SW_Transformer's whole-block "
                        "kernels in bf16 (#1-bf16 to #3-bf16) and DeepSense's conv blocks in bf16 "
                        "(with -pallas_conv, #13-bf16/#14-bf16). Default float32, as the JAX "
                        "CLI's off the TPU.")
    parser.add_argument("-device", type=str, default="cuda",
                        help="cuda (default: this process's card) | cpu.")
    parser.add_argument("-data_parallel", type=int, default=0,
                        help="Processes on the data axis, each training its rows of the batch "
                        "(0: the process count over -model_parallel).")
    parser.add_argument("-model_parallel", type=int, default=1,
                        help="Processes on the model axis (tensor parallelism: SW_Transformer's "
                        "heads and widths, DeepSense's conv channels, split over them; 1 = "
                        "none).")
    parser.add_argument("-dist_coordinator", type=str, default=None,
                        help="host:port of the process group's rendezvous (process 0 listens "
                        "there); also via FOCAL_DIST_COORDINATOR.")
    parser.add_argument("-dist_num_processes", type=int, default=0,
                        help="Process count, one per card; also via FOCAL_DIST_NUM_PROCESSES.")
    parser.add_argument("-dist_process_id", type=int, default=None,
                        help="This process's rank in [0, dist_num_processes); also via "
                        "FOCAL_DIST_PROCESS_ID.")
    parser.add_argument("-data_layout", type=str, default="auto",
                        choices=["auto", "replicated", "sharded"],
                        help="Train-split placement: replicated (every process holds the split), "
                        "or sharded over the data ranks (each holds its rows and shuffles them "
                        "locally); auto is replicated. -model_parallel and a streamed split "
                        "take replicated.")
    parser.add_argument("-grad_accum", type=_positive_int, default=1,
                        help="Accumulate the gradients of N consecutive micro-batches of "
                        "-batch_size and update once (an effective batch of N x -batch_size). "
                        "FOCAL pretraining gathers the micro-batches' features into one loss "
                        "(GradCache, two passes); the classifier stages and -no_accum_gather "
                        "average the micro-batches' gradients (optax.MultiSteps).")
    parser.add_argument("-no_accum_gather", action="store_true",
                        help="With -grad_accum N in FOCAL pretraining, average the micro-batches' "
                        "gradients (negatives per micro-batch) instead of gathering features.")
    parser.add_argument("-hbm_budget_gb", type=float, default=0,
                        help="Device memory (GiB) the train split may take; a larger split "
                        "streams from pinned host memory in double-buffered blocks. 0: 60%% of "
                        "the card's memory (8 GiB on the CPU).")
    parser.add_argument("-stream_block_steps", type=int, default=0,
                        help="Steps a streamed block holds (0: 64).")
    # the attribution arms (pretraining; the classifier stages ignore the
    # first two, as in the JAX package)
    parser.add_argument("-ragged_tail", action="store_true",
                        help="Pretrain: one extra update an epoch on the permutation's leftover "
                        "subsequences, as the reference's sampler yields them (a tail of one "
                        "subsequence stays dropped: its ranking loss is NaN).")
    parser.add_argument("-py_aug_draws", action="store_true",
                        help="Pretrain: pick each view's augmenter from a table of Python "
                        "random.Random(-seed) draws, as the reference does on the host.")
    parser.add_argument("-init_weight", type=str, default=None,
                        help="Initialise the parameters (and BatchNorm statistics) from this "
                        "params file (a _latest/_best file, or an import saved with save_params) "
                        "before training, in any stage.")
    parser.add_argument("-ref_lr_timing", action="store_true",
                        help="The reference loop's epoch-end scheduler step: epoch e trains at "
                        "lr(e - 1), epoch 0 at lr(0).")
    parser.add_argument("-torch_out", type=str, default=None,
                        help="export_torch: the reference-format .pt file to write.")
    parser.add_argument("-epochs_per_call", type=int, default=0,
                        help="Epochs a block runs (0 = auto: a whole validation interval once "
                        "at least five remain, else 1; capped at -val_epochs). The train loss "
                        "at a validation point is the mean of its block's epoch means.")
    parser.add_argument("-profile_dir", type=str, default=None,
                        help="Trace the first epoch after the start (a block of its own) with "
                        "torch.profiler, the card's kernels included, as a Chrome trace in this "
                        "directory.")
    parser.add_argument("-knn_backend", type=str, default="sklearn", choices=["sklearn", "jnp"],
                        help="The JAX CLI's KNN probe backends; both run the port's KNN "
                        "(scikit-learn's defaults, in torch) on the features' device.")
    parser.add_argument("-prng_impl", type=str, default=None,
                        help="Refused: it selects JAX's PRNG implementation; the port draws "
                        "from torch's Philox generators.")
    _add_shared_flags(parser)
    return parser


def _positive_int(text):
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"{text} is not a positive integer")
    return value


def _index(text):
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"{text} is not a card index")
    return value


def _check_layout(args):
    """The process layout's refusal of several processes without a
    rendezvous to join them, before any process group is joined. Under
    -model_parallel, -pallas_mlp and -pallas_conv take their flag-off routes
    (models.registry.apply_plan), as the JAX package's registry builds them;
    a line says so."""
    coord, nproc, _ = topology(args)
    mp = max(1, args.model_parallel)
    dp = args.data_parallel if args.data_parallel > 0 else max(1, (nproc or 1) // mp)
    flags = [f for f, on in (("-pallas_mlp", args.pallas_mlp), ("-pallas_conv", args.pallas_conv))
             if on]
    if mp > 1 and flags:
        logging.info(f"= {' and '.join(flags)} under -model_parallel {mp}: the flag-off routes "
                     "(the Swin MLPs' Dense pair, the conv blocks' cuDNN convs), as the JAX "
                     "package takes them on a model axis")
    if args.gpu is not None and (dp * mp > 1 or (nproc or 1) > 1):
        raise ValueError(f"-gpu {args.gpu} names one card, but this run has several processes, "
                         "each of which takes a card of its own (cuda:{local rank % cards}); "
                         "leave -gpu out, or choose the cards with CUDA_VISIBLE_DEVICES")
    if dp * mp > 1 and not coord:
        raise ValueError(f"-data_parallel {dp} x -model_parallel {mp} runs one process per card: "
                         "start each with -dist_coordinator host:port, -dist_num_processes "
                         f"{dp * mp} and its -dist_process_id (or the FOCAL_DIST_* variables)")


def parse_train_params(argv=None, option="train"):
    """Parse training flags and fill the derived fields (recipe, task,
    train_mode, batch_size, option)."""
    return fill_train_params(build_train_parser().parse_args(argv), option)


def fill_train_params(args, option="train"):
    """parse_train_params's checks and derived fields on parsed ``args``
    (the sweep fills each of its runs so). The attribution arms refuse
    accumulation and a sharded layout, as the JAX package's pretraining
    does."""
    args.option = option
    if args.prng_impl is not None:
        raise ValueError(f"-prng_impl {args.prng_impl}: the flag selects JAX's PRNG implementation "
                         "(threefry2x32 or rbg); the port draws from torch's Philox generators "
                         "(train/state.py), so it has nothing to select")
    if (args.py_aug_draws or args.ragged_tail) and (
            args.grad_accum > 1 or args.data_layout == "sharded"):
        raise ValueError("-py_aug_draws/-ragged_tail are attribution arms for the replicated "
                         "single-step layout (no streaming/sharded/grad_accum)")
    _check_layout(args)
    # the process group first: the card depends on this process's rank
    maybe_initialize(args)
    args.device = device_for(_gpu_device(args))
    args.dataset_config = cli_dataset_config(args)
    if args.task is None:
        args.task = default_task(args.dataset, args.dataset_config)
    args.train_mode = get_train_mode(args.learn_framework)
    if args.batch_size is None:
        args.batch_size = 256 if args.stage == "pretrain" else 128
    return args


def parse_test_params(argv=None):
    """The evaluation CLI's flags: the training flags, as the JAX package's
    ``parse_test_params`` takes them."""
    return parse_train_params(argv, option="test")
