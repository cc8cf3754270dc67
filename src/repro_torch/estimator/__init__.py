from repro_torch.estimator import model, train  # noqa: F401
