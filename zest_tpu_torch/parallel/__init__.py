"""The distribution plane: the slot mesh (``mesh``), the ownership plans
(``plan``), the pod round's gather (``collectives``), the two-tier
multi-pod gather (``hierarchy``), the HBM staging tier (``hbm``) and
discovery over the process group's store (``coordinator``)."""

from zest_tpu_torch.parallel.collectives import (  # noqa: F401
    GatheredPool,
    PodDistributor,
    PoolLayout,
    all_gather_throughput,
    pack_rows,
    split_waves,
)
from zest_tpu_torch.parallel.coordinator import (  # noqa: F401
    CoordinatorRegistry,
    InMemoryRegistry,
)
from zest_tpu_torch.parallel.hierarchy import (  # noqa: F401
    HierarchicalDistributor,
    HierarchicalPlan,
    hier_mesh,
    owner_pod_host,
)
from zest_tpu_torch.parallel.hbm import (  # noqa: F401
    HbmStagingCache,
    TieredCache,
)
from zest_tpu_torch.parallel.mesh import num_slots, pod_mesh  # noqa: F401
from zest_tpu_torch.parallel.plan import (  # noqa: F401
    DistributionPlan,
    FetchAssignment,
    owner_host,
)
