"""Experiment folders (the port's copy of the JAX package's
``params/output_paths.py``): auto-numbered
``weights/{dataset}_{model}/exp{N}_{suffix}/`` folders under -output_dir
(else the working directory), the suffix ``contrastive_{framework}`` for
FOCAL pretraining and finetuning and ``supervised_{task}_{label_ratio}``
for supervised training; a snapshot of the recipe sections, the stage's
log file, and the best/latest/resume checkpoint names, as torch files.

Pretraining and supervised training make a new folder (or, with -resume,
reuse one); finetuning and the test CLI reuse -model_weight or the newest
matching folder. Each stage logs to its own file there, so a finetune run
leaves pretrain_log.txt as it was."""

import json
import logging
import os


def _models_folder(args):
    return os.path.join(args.output_dir or os.getcwd(), "weights", f"{args.dataset}_{args.model}")


def weight_suffix(args):
    if args.train_mode == "supervised":
        suffix = f"supervised_{args.task}_{args.label_ratio}"
    else:
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


def stage_log_name(args):
    if args.train_mode == "supervised":
        return "train_log.txt"
    if args.stage == "pretrain":
        return "pretrain_log.txt"
    return f"{args.task}_{args.label_ratio}_{args.stage}_log.txt"


def set_model_weight_folder(args):
    """Pick the run's folder into ``args.weight_folder``: with -resume,
    finetuning or the test CLI (``args.option`` "test") the -model_weight
    folder or the newest matching one; else a new exp{N+1} with the recipe
    snapshot. A training run logs to its stage's log file there (appending
    on -resume) and to stderr."""
    folder = _models_folder(args)
    os.makedirs(folder, exist_ok=True)
    newest_id, newest = find_most_recent_weight(args)
    option = getattr(args, "option", "train")
    if args.resume or args.stage == "finetune" or option == "test":
        weight_folder = args.model_weight or newest
        if weight_folder is None:
            raise FileNotFoundError(f"no experiment folder {weight_suffix(args)} under {folder}")
    else:
        weight_folder = os.path.join(folder, f"exp{newest_id + 1}_{weight_suffix(args)}")
        os.makedirs(weight_folder, exist_ok=True)
        with open(os.path.join(weight_folder, "model_config.json"), "w") as f:
            json.dump(args.dataset_config[args.model], f, indent=4)
        if args.train_mode != "supervised" and args.stage == "pretrain":
            with open(os.path.join(weight_folder, "learn_framework_config.json"), "w") as f:
                json.dump(args.dataset_config[args.learn_framework], f, indent=4)
    if option == "train":
        args.train_log_file = os.path.join(weight_folder, stage_log_name(args))
        if not args.resume and os.path.exists(args.train_log_file):
            os.remove(args.train_log_file)
        logging.basicConfig(level=logging.INFO, force=True, format="%(message)s",
                            handlers=[logging.FileHandler(args.train_log_file),
                                      logging.StreamHandler()])
        logging.info(f"=\t[Model weights path]: {weight_folder}")
    args.weight_folder = weight_folder
    return args


def checkpoint_paths(args, stage=None):
    """(best, latest, resume) checkpoint files of the run's stage, or of
    ``stage`` ("pretrain": the files finetuning loads from)."""
    if args.train_mode == "supervised":
        base = f"{args.dataset}_{args.model}_{args.task}"
    elif (stage or args.stage) == "pretrain":
        base = f"{args.dataset}_{args.model}_pretrain"
    else:
        base = f"{args.dataset}_{args.model}_{args.task}_{args.label_ratio}_finetune"
    base = os.path.join(args.weight_folder, base)
    return tuple(f"{base}_{kind}.pt" for kind in ("best", "latest", "resume"))
