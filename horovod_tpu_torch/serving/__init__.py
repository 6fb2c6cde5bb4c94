"""Serving: generation bundles, the row-splice decoder, the continuous
batching engine and its paged-KV admission budget."""

from horovod_tpu_torch.serving.bundle import (
    GenerateBundle,
    export_generate,
    is_generate_bundle,
    load_generate,
)

__all__ = [
    "GenerateBundle",
    "export_generate",
    "is_generate_bundle",
    "load_generate",
]
