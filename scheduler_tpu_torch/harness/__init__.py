from scheduler_tpu_torch.harness.synthetic import (
    SyntheticCluster,
    aftermath_thin_requests,
    config2_churn,
    config3_churn,
    job_template_request,
    make_gpu_topology_cluster,
    make_kubemark_density_cluster,
    make_mq_ladder_cluster,
    make_reclaim_aftermath_cluster,
    make_reclaim_cluster,
    make_synthetic_cluster,
    retire_jobs,
)

__all__ = ["SyntheticCluster", "aftermath_thin_requests", "config2_churn", "config3_churn",
           "job_template_request",
           "make_gpu_topology_cluster", "make_kubemark_density_cluster", "make_mq_ladder_cluster",
           "make_reclaim_aftermath_cluster", "make_reclaim_cluster", "make_synthetic_cluster",
           "retire_jobs"]
