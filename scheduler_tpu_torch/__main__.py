"""``python -m scheduler_tpu_torch`` == the scheduler daemon (cmd/kube-batch/main.go)."""

from scheduler_tpu_torch.cli import main

if __name__ == "__main__":
    main()
