"""Host runtime of the port: the native shard store (``shard_store.py``)."""

from pstl_tpu_torch.runtime.shard_store import ShardStore, write_store  # noqa: F401
