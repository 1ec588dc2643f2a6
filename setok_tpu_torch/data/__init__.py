"""Data: conversations and preprocessing, datasets, the collator, the
length-grouped sampler and the loaders, text tokenizers, image
preprocessing and the VQA metric. The exports are the JAX package's
(`setok_tpu/data/__init__.py`)."""

from setok_tpu_torch.data.collator import Collator
from setok_tpu_torch.data.datasets import (EditingDataset,
                                           InstructionTuningDataset,
                                           LazySupervisedDataset,
                                           TextImagePairDataset)
from setok_tpu_torch.data.sampler import LengthGroupedSampler

# the reference exports the collator under this name
DataCollatorForSupervisedDataset = Collator

__all__ = ["Collator", "DataCollatorForSupervisedDataset", "EditingDataset",
           "InstructionTuningDataset", "LazySupervisedDataset",
           "TextImagePairDataset", "LengthGroupedSampler"]
