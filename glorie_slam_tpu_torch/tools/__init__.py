"""Run tools of the port: ``python -m glorie_slam_tpu_torch.tools.<name>``
(``long_run_synthetic``, ``mapper_schedule_run``, ``run_suite``)."""
