"""Kernel-attribution tools: time each primitive of the rollout kernels alone
on the card (``python3 -m live_ekf_slam_tpu_torch.tools.micro_downdate``,
``.micro_ukf``, ``.micro_ukf_probe``)."""
