"""Weight converters into the port's reference-keyed state_dicts."""

from lgteun_tpu_torch.convert.from_jax import lgteun_from_flax  # noqa: F401
