"""Data: distributed datasets on the port's object store (Ray Data
parity; counterpart of ``ray_tpu/data``), on a numpy block format
(``block.py``) with the device feeder ``Dataset.iter_cuda_batches``.
Importing it imports neither torch, pyarrow nor pandas."""

from ray_tpu_torch.data.compute import ActorPoolStrategy
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_csv,
    read_json,
    read_parquet,
)

__all__ = [
    "ActorPoolStrategy", "DataContext",
    "Dataset", "DatasetPipeline", "Datasource", "GroupedData", "ReadTask",
    "from_arrow", "from_items", "from_numpy", "from_pandas", "range",
    "read_csv", "read_datasource", "read_json", "read_parquet",
    "write_datasource",
]
from ray_tpu_torch.data.datasource import (  # noqa: E402,F401
    Datasource,
    ReadTask,
    read_datasource,
    write_datasource,
)
