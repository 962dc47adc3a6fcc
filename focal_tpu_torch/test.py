"""Evaluation CLI of the port (the JAX package's root test.py):

    python -m focal_tpu_torch.test -dataset MOD -model SW_Transformer \
        -learn_framework FOCAL -stage finetune -synthetic -output_dir runs

Loads the stage's `_best` classifier (supervised with ``-learn_framework
no``, finetuned with ``-stage finetune``) from -model_weight's folder or the
newest matching experiment folder, runs the test split through the class
head and prints the test loss, accuracy, macro-F1 and confusion matrix (a
regression task: the loss and the MSE). On
the CUDA card, or on the CPU with ``-device cpu``; ``-pallas_mlp`` runs the
Swin MLPs through the fused MLP kernel (#10), ``-no_pallas_block`` the
window attention through the attention-only kernel (#6),
``-compute_dtype bfloat16`` the model in bf16 (#1-bf16). With the training
CLI's process flags (``-data_parallel``, ``-model_parallel``, ``-dist_*``)
each process evaluates its shard and the process of rank 0 prints.
"""

import logging

import torch

from focal_tpu_torch.data import DeviceDataLoader, load_split
from focal_tpu_torch.models import build_backbone
from focal_tpu_torch.ops.augment import Augmenter
from focal_tpu_torch.output_paths import checkpoint_paths
from focal_tpu_torch.parallel import distributed
from focal_tpu_torch.parallel.mesh import make_mesh_plan
from focal_tpu_torch.params import parse_test_params, select_device
from focal_tpu_torch.train import evaluate as ev
from focal_tpu_torch.train.loops import place_model, prepare_folder


def test(args):
    """(test loss, accuracy, macro-F1) of the stage's `_best` file on the
    test split (the confusion matrix is printed); (test loss, MSE) for a
    regression task."""
    device = select_device(args.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    prepare_folder(args)
    mesh = make_mesh_plan(args.data_parallel, args.model_parallel)
    args.classifier_weight = checkpoint_paths(args)[0]
    split = load_split("test", args).to(device)
    model = build_backbone(args.dataset_config, args.model, args.task, args.learn_framework,
                           pallas_conv=args.pallas_conv, pallas_mlp=args.pallas_mlp,
                           pallas_block=not args.no_pallas_block,
                           compute_dtype=args.compute_dtype)
    logging.info(f"= Loading classifier weight: {args.classifier_weight}")
    model = place_model(model, device, mesh, args.classifier_weight)
    plan = ev.EvalPlan(DeviceDataLoader(split, args.batch_size), device)
    test_loss, metrics = ev.eval_supervised(args, model, Augmenter(args.dataset_config), plan,
                                            split.data, mesh)
    if not distributed.is_main():
        return (test_loss, metrics[0]) if "regression" in args.task else (
            test_loss, metrics[0], metrics[1])
    if "regression" in args.task:
        print(f"Test classifier loss: {test_loss: .5f}, test mse: {metrics[0]: .5f}")
        return test_loss, metrics[0]
    print(f"Test classifier loss: {test_loss: .5f}")
    print(f"Test acc: {metrics[0]: .5f}, test f1: {metrics[1]: .5f}")
    print(f"Test confusion matrix:\n {metrics[2]}")
    return test_loss, metrics[0], metrics[1]


def main(argv=None):
    return test(parse_test_params(argv))


if __name__ == "__main__":
    main()
