from scheduler_tpu_torch.harness.synthetic import (
    SyntheticCluster,
    make_kubemark_density_cluster,
    make_synthetic_cluster,
)

__all__ = ["SyntheticCluster", "make_kubemark_density_cluster", "make_synthetic_cluster"]
