from repro_torch.channel import iq, kpm, scenarios, throughput  # noqa: F401
