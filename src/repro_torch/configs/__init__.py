from repro_torch.configs.registry import ARCHS, SHAPES, DIT_SHAPES, SUBQUADRATIC, cells, get, get_smoke  # noqa: F401
