"""Experiment folders (the port's copy of the JAX package's
``params/output_paths.py``, for contrastive pretraining, the stage ported):
auto-numbered ``weights/{dataset}_{model}/exp{N}_contrastive_{framework}/``
folders under -output_dir (else the working directory), a snapshot of the
recipe sections, the stage's log file, and the best/latest/resume
checkpoint names, as torch files."""

import json
import logging
import os


def _models_folder(args):
    return os.path.join(args.output_dir or os.getcwd(), "weights", f"{args.dataset}_{args.model}")


def weight_suffix(args):
    suffix = f"{args.train_mode}_{args.learn_framework}"
    return suffix if args.tag is None else f"{suffix}-{args.tag}"


def find_most_recent_weight(args):
    """(N, folder) of the newest exp{N}_{suffix} folder matching the run,
    (-1, None) if there is none."""
    folder, suffix = _models_folder(args), weight_suffix(args)
    newest_id, newest = -1, None
    if os.path.isdir(folder):
        for name in os.listdir(folder):
            if not name.startswith("exp") or name.split("_", 1)[-1] != suffix:
                continue
            try:
                n = int(name.split("_")[0][3:])
            except ValueError:
                continue
            if n > newest_id:
                newest_id, newest = n, os.path.join(folder, name)
    return newest_id, newest


def set_model_weight_folder(args):
    """Pick the run's folder into ``args.weight_folder``: a new exp{N+1}
    with the recipe snapshot, or with -resume the -model_weight folder or
    the newest matching one. Logs to pretrain_log.txt there (appending on
    -resume) and to stderr."""
    folder = _models_folder(args)
    os.makedirs(folder, exist_ok=True)
    newest_id, newest = find_most_recent_weight(args)
    if args.resume:
        weight_folder = args.model_weight or newest
        if weight_folder is None:
            raise FileNotFoundError(f"-resume: no experiment folder under {folder} to resume")
    else:
        weight_folder = os.path.join(folder, f"exp{newest_id + 1}_{weight_suffix(args)}")
        os.makedirs(weight_folder, exist_ok=True)
        with open(os.path.join(weight_folder, "model_config.json"), "w") as f:
            json.dump(args.dataset_config[args.model], f, indent=4)
        with open(os.path.join(weight_folder, "learn_framework_config.json"), "w") as f:
            json.dump(args.dataset_config[args.learn_framework], f, indent=4)
    args.train_log_file = os.path.join(weight_folder, "pretrain_log.txt")
    if not args.resume and os.path.exists(args.train_log_file):
        os.remove(args.train_log_file)
    logging.basicConfig(level=logging.INFO, force=True, format="%(message)s",
                        handlers=[logging.FileHandler(args.train_log_file), logging.StreamHandler()])
    logging.info(f"=\t[Model weights path]: {weight_folder}")
    args.weight_folder = weight_folder
    return args


def checkpoint_paths(args):
    """(best, latest, resume) checkpoint files of pretraining."""
    base = os.path.join(args.weight_folder, f"{args.dataset}_{args.model}_pretrain")
    return tuple(f"{base}_{kind}.pt" for kind in ("best", "latest", "resume"))
