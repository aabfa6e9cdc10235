"""The port's copies of the shipped configs (`lgteun_tpu_torch/configs`,
which `chip_smoke.py` and `scripts/torch_latency_ab.py` run) against the
JAX package's originals (`lgteun_tpu/configs`): the port's `load_config`
reads each pair into equal values, field by field and every other
module-level name (`extras`) too, so the copies cannot drift; and the
port's Config fields against the JAX Config's."""

import dataclasses
import logging
import os

import pytest

from lgteun_tpu.config import Config as JaxConfig
from lgteun_tpu_torch.config import Config, load_config
from lgteun_tpu_torch.registry import build_model
from lgteun_tpu_torch.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["unlg_former", "lightnet", "MDCUN",
                                  "INNT", "PanFormer", "SFIIN", "MutInf",
                                  "GSA", "SFIM", "Wavelet"])
def test_port_config_copy_equals_jax_original(name):
    got = load_config(os.path.join(REPO, "lgteun_tpu_torch", "configs",
                                   f"{name}.py"))
    want = load_config(os.path.join(REPO, "lgteun_tpu", "configs",
                                    f"{name}.py"))
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.model_type == want.model_type and got.ms_chans == 8


def _default(f):
    value = (f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) \
        else value


def test_port_config_fields_are_the_jax_configs():
    """Every field of the port's Config is a field of the JAX Config with
    its default, `mesh_shape` (the data-parallel mesh)
    with its type too; the JAX fields that the port keeps in `extras`
    are read there (`remat`, `mixed_precision`), warned of by the Runner
    (`steps_per_dispatch`) or read by nothing in either package
    (`use_sewar`): none is ignored silently."""
    port = {f.name: f for f in dataclasses.fields(Config)}
    jax_fields = {f.name: f for f in dataclasses.fields(JaxConfig)}
    assert set(port) <= set(jax_fields)
    assert set(jax_fields) - set(port) == {
        "remat", "mixed_precision", "steps_per_dispatch", "use_sewar"}
    for name, f in port.items():
        assert _default(f) == _default(jax_fields[name]), name
    assert port["mesh_shape"].type == jax_fields["mesh_shape"].type


def test_steps_per_dispatch_is_warned_of(caplog):
    """The JAX Runner's TPU dispatch setting changes no number in the
    port, which says so where a config sets it."""
    cfg = Config(ms_chans=4, model_cfg={"core_module": {"stage": 1}})
    cfg.extras["steps_per_dispatch"] = 4
    with caplog.at_level(logging.WARNING, logger="lgteun_torch"):
        Runner(cfg, build_model("UnlgFormer", cfg, device="cpu"), "cpu")
    assert any("steps_per_dispatch=4" in r.message for r in caplog.records)
