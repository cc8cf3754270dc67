from repro_torch.estimator import model, serve, train  # noqa: F401
