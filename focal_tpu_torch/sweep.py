"""Label-ratio sweep of the port (the JAX package's root sweep.py):
finetune (or train supervised) across label ratios and tasks, and collate
the best validation accuracies into one table.

    # FOCAL finetune sweep from the newest pretrain run
    python -m focal_tpu_torch.sweep -model DeepSense -dataset MOD -learn_framework FOCAL \
        -stage finetune -ratios 0.01,0.1,0.5,1.0 -synthetic

    # supervised baseline sweep
    python -m focal_tpu_torch.sweep -model DeepSense -dataset MOD -learn_framework no \
        -ratios 0.1,1.0 -synthetic

Takes every training flag of ``python -m focal_tpu_torch.train`` besides
``-ratios``, ``-tasks`` (the recipe's default task without it) and ``-out``
(the JSON rows ``task``, ``label_ratio``, ``best_val_acc``).
"""

import argparse
import json
import logging

from focal_tpu_torch.params import build_train_parser, fill_train_params
from focal_tpu_torch.train.loops import finetune, supervised_train


def build_sweep_parser():
    parser = build_train_parser()
    parser.add_argument("-ratios", type=str, default="0.1,0.5,1.0",
                        help="Comma-separated label ratios.")
    parser.add_argument("-tasks", type=str, default=None,
                        help="Comma-separated tasks (default: the recipe's default task).")
    parser.add_argument("-out", type=str, default="sweep_results.json")
    return parser


def sweep(argv_args):
    """One run per (task, ratio), in that order -> the result rows."""
    ratios = [float(r) for r in argv_args.ratios.split(",")]
    tasks = argv_args.tasks.split(",") if argv_args.tasks else [None]
    results = []
    for task in tasks:
        for ratio in ratios:
            args = argparse.Namespace(**vars(argv_args))
            args.label_ratio = ratio
            args.task = task
            args = fill_train_params(args)
            logging.info(f"=== sweep: task={args.task} label_ratio={ratio} ===")
            if args.train_mode == "supervised":
                _, best_acc, _ = supervised_train(args)
            else:
                args.stage = "finetune"
                _, best_acc, _ = finetune(args)
            results.append({"task": args.task, "label_ratio": ratio, "best_val_acc": best_acc})
    return results


def main(argv=None):
    argv_args = build_sweep_parser().parse_args(argv)
    results = sweep(argv_args)
    with open(argv_args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\n{'task':<28}{'ratio':>8}{'best val acc':>14}")
    for r in results:
        print(f"{r['task']:<28}{r['label_ratio']:>8}{r['best_val_acc']:>14.4f}")
    print(f"\nwritten to {argv_args.out}")
    return results


if __name__ == "__main__":
    main()
