from scheduler_tpu_torch.harness.synthetic import SyntheticCluster, make_synthetic_cluster

__all__ = ["SyntheticCluster", "make_synthetic_cluster"]
