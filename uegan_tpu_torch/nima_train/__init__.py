"""NIMA training sub-project, counterpart of uegan_tpu/nima_train/: AVA
dataset cleaning and splitting, EMD-loss training of the MobileNetV2
scorer, validation and single-image scoring."""

from uegan_tpu_torch.nima_train.dataset import AVADataset, clean_and_split
from uegan_tpu_torch.nima_train.train import train_nima, validate_nima

__all__ = ["AVADataset", "clean_and_split", "train_nima", "validate_nima"]
