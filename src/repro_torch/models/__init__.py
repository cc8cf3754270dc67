from repro_torch.models import vgg  # noqa: F401
