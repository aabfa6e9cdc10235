"""The port's copies of the shipped configs (`lgteun_tpu_torch/configs`,
which `chip_smoke.py` and `scripts/torch_latency_ab.py` run) against the
JAX package's originals (`lgteun_tpu/configs`): the port's `load_config`
reads each pair into equal values, field by field and every other
module-level name (`extras`) too, so the copies cannot drift."""

import dataclasses
import os

import pytest

from lgteun_tpu_torch.config import Config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["unlg_former", "lightnet", "MDCUN",
                                  "INNT", "GSA", "SFIM", "Wavelet"])
def test_port_config_copy_equals_jax_original(name):
    got = load_config(os.path.join(REPO, "lgteun_tpu_torch", "configs",
                                   f"{name}.py"))
    want = load_config(os.path.join(REPO, "lgteun_tpu", "configs",
                                    f"{name}.py"))
    for f in dataclasses.fields(Config):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.model_type == want.model_type and got.ms_chans == 8
