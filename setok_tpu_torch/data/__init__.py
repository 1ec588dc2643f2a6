"""Data: text tokenizers, image preprocessing, the VQA metric."""
