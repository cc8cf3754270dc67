from repro_torch.estimator import model, serve, ssm, train  # noqa: F401
