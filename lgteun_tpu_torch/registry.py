"""The port's model registry: string -> Method class (its own instance,
so both packages can register "UnlgFormer" in one process)."""

from __future__ import annotations

from typing import Callable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: dict[str, type] = {}

    def register(self, name: str | None = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._entries:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._entries[key] = obj
            return obj

        return deco

    def get(self, key: str):
        if key not in self._entries:
            raise KeyError(f"{key!r} not found in registry {self.name!r}; "
                           f"available: {sorted(self._entries)}")
        return self._entries[key]


MODELS = Registry("torch_models")


def build_model(model_type: str, cfg, device):
    """Look up a registered port Method and build it on `device`."""
    import lgteun_tpu_torch.models  # noqa: F401  (populates MODELS)

    return MODELS.get(model_type)(cfg, device=device)
