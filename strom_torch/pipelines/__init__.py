"""Workload pipelines: ``make_*_pipeline()`` iterators yielding batches as
torch tensors on one device (the Llama pretrain loader, BASELINE config #4,
the vision loaders of config #2 and the ViT-B/16 loader of config #3), and
the Parquet scan of config #5 (``parquet_scan_aggregate``,
``parquet_count_where``), which returns host aggregates."""

from strom_torch.pipelines.base import Pipeline  # noqa: F401
from strom_torch.pipelines.llama_pretrain import make_llama_pipeline  # noqa: F401
from strom_torch.pipelines.parquet_scan import (  # noqa: F401
    parquet_count_where, parquet_scan_aggregate)
from strom_torch.pipelines.sampler import (  # noqa: F401
    EpochShuffleSampler, SamplerState, load_loader_state, save_loader_state)
from strom_torch.pipelines.vision import (  # noqa: F401
    make_imagenet_resnet_pipeline, make_predecoded_vision_pipeline,
    make_vit_wds_pipeline, make_wds_vision_pipeline)
