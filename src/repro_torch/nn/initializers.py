"""Parameter initializers — port of ``repro/nn/initializers.py`` on the
threefry keys of ``repro_torch.diffusion.rng``: each draws what the
reference's draws from the same key (uniforms bit for bit, normals as
closely as ``rng.normal`` says) on the key's device."""
import torch

from repro_torch.diffusion import rng


def normal(stddev=0.02):
    def init(key, shape, dtype=torch.float32):
        return (rng.normal(key, shape) * stddev).to(dtype)
    return init


def truncated_normal(stddev=0.02):
    def init(key, shape, dtype=torch.float32):
        return (rng.truncated_normal(key, -2.0, 2.0, shape)
                * stddev).to(dtype)
    return init


def zeros(key, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=key.device)


def ones(key, shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=key.device)


def xavier_uniform():
    def init(key, shape, dtype=torch.float32):
        fan_in, fan_out = shape[0], shape[-1]
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        return rng.uniform(key, shape, -limit, limit).to(dtype)
    return init


def lecun_normal():
    def init(key, shape, dtype=torch.float32):
        fan_in = shape[0]
        return (rng.normal(key, shape) * (1.0 / fan_in) ** 0.5).to(dtype)
    return init
