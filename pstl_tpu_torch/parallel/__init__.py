"""Data and candidate parallelism over ``torch.distributed`` (the port of
``pstl_tpu/parallel``): one process a card, launched by ``torchrun``."""

from pstl_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, shard_batch, replicate, data_sharding, psum_metrics,
    candidate_sharding, constrain_candidates)
from pstl_tpu_torch.parallel.distributed import (  # noqa: F401
    init_multihost, global_batch_from_local, local_rows)
