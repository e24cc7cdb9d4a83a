"""Procedural datasets (numpy generation, bit-identical to ``repro.data``)."""
from repro_torch.data.synthetic import (DATASETS, cifar_like, image_store,
                                        make_dataset, procedural_images)

__all__ = ["DATASETS", "cifar_like", "image_store", "make_dataset",
           "procedural_images"]
