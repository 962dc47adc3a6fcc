"""Augmentation pipeline: the eval/serving form only.

The JAX package's ``Augmenter`` (``ops/augment.py``) also holds the fixed
and random training pools over 13 augmenters; they come with the training
port. Serving uses ``no``: the FFT and nothing else.
"""

from focal_tpu_torch.ops.fft import fft_preprocess


class Augmenter:
    """Static pipeline built from the dataset recipe; ``no(time_x) -> freq_x``."""

    def __init__(self, dataset_config):
        self.modalities = dataset_config["modality_names"]
        self.locations = dataset_config["location_names"]

    def no(self, time_loc_inputs):
        """FFT only."""
        return fft_preprocess(time_loc_inputs)
