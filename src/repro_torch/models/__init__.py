from repro_torch.models.zoo import build_model  # noqa: F401
