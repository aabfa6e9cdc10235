"""Reference (PyTorch) checkpoints -> the port's Runner checkpoint
(counterpart of `scripts/convert_torch_ckpt.py` and of the key rules of
`lgteun_tpu/convert/torch_import.py`).

The reference saves a checkpoint as a pickle of WHOLE `nn.Module`s by
module name plus "iter_num" (reference base_model.py:354-369); the
authors' released weights use that format. Unpickling it the usual way
needs the reference's classes (its `models` package and what that
imports), which no host of the port has, and runs whatever the pickle
names. `load_reference_checkpoint` reads it with neither:

- a restricted unpickler, handed to `torch.load(weights_only=False,
  pickle_module=...)`, resolves only torch's tensor rebuild functions,
  dtypes, sizes and devices, the classes of `torch.nn`, `collections`,
  `copyreg` / `_codecs`, numpy dtypes and scalars, a few builtins (`set`,
  `frozenset`, ...) and `logging.getLogger`. A protocol-2 pickle names
  builtins `__builtin__.set` and copyreg `copy_reg`: names go through
  pickle's own Python-2 mapping first;
- every other class becomes an inert stand-in (`StandIn`) that keeps its
  pickled state and runs no code of the class;
- a pickle that would CALL anything else (REDUCE on `os.system`,
  `builtins.eval`, a stand-in class, ...) is refused before the call
  (`pickle.UnpicklingError`).

Each module is then walked as `nn.Module.state_dict` walks one:
`_parameters`, `_buffers` less `_non_persistent_buffers_set`, then
`_modules`, into dotted keys. That works for stand-ins and real modules
alike, so `state_dict()` is never called on a tree that holds stand-ins.
A checkpoint of state_dicts ({name: state_dict} with or without
"iter_num", or one bare state_dict, the core module's) loads too, as
`scripts/convert_torch_ckpt.py::load_torch_state_dicts` allows, and so
does torch's legacy (non-zip) format.

The port's modules carry the reference's keys (`convert/from_jax.py`),
MDCUN's aliases and PanFormer's Swin masks included, so the conversion
is a strict load: the core module's state_dict becomes the Runner
checkpoint's "state_dict", MutInf's second module `mi` (JAX
`AUX_CONVERTERS`) its "modules", with "iter_num" and no optimiser state
(`Runner.load_checkpoint` restores `last_iter` and sets no optimiser
from it). With a config, the CLI also builds the method on the CPU and
loads every module strictly before it writes:

    python -m lgteun_tpu_torch.convert.from_reference --model-type X \\
        --torch-ckpt model_iter_35000.pth --out model_iter_35000.pt \\
        [-c lgteun_tpu_torch/configs/unlg_former.py]
    python -m lgteun_tpu_torch.main -c CONFIG --test-only \\
        --checkpoint model_iter_35000.pt

`write_reference_checkpoint` writes a file of that format from the
port's modules, for the loader's checks: every class of a module's tree
outside `torch.nn` is declared, for the time of the save only, as a
class of the reference's module path (`REFERENCE_CLASSES`).
"""

from __future__ import annotations

import _compat_pickle
import argparse
import copy
import logging
import pickle
import sys
import types
import warnings

import torch
from torch import nn

__all__ = ["REFERENCE_CLASSES", "AUX_CLASSES", "StandIn",
           "load_reference_checkpoint", "module_state_dict",
           "convert_reference_checkpoint", "write_reference_checkpoint"]

# the core module's class in the reference, by registry name (reference
# models/*.py; tests/test_torch_parity.py imports each)
REFERENCE_CLASSES = {
    "UnlgFormer": "models.unlg_former.Pansharpening",
    "lightnet": "models.lightnet.LightNet",
    "PanFormer": "models.panformer.CrossSwinTransformer",
    "SFIIN": "models.SFIIN.Net",
    "MutInf": "models.MutInf.GPPNN",
    "INNT": "models.INNT.GPPNN",
    "MDCUN": "models.MDCUN.pan_unfolding",
}
# the other modules a method checkpoints (reference MutInf.py:452-462,
# base/losses.py:162-219), by registry name and module name
AUX_CLASSES = {
    "MutInf": {"mi": "models.base.losses.Mutual_info_reg"},
}

_BUILTINS = frozenset({"set", "frozenset", "bytearray", "bytes", "complex",
                       "slice", "range", "tuple", "list", "dict", "int",
                       "float", "bool", "str"})
_GLOBALS = frozenset({
    ("collections", "OrderedDict"), ("collections", "Counter"),
    ("collections", "defaultdict"), ("collections", "deque"),
    ("copyreg", "_reconstructor"), ("copyreg", "__newobj__"),
    ("copyreg", "__newobj_ex__"), ("_codecs", "encode"),
    ("logging", "getLogger"), ("torch", "Size"), ("torch", "device"),
    ("torch", "Tensor"), ("torch.serialization", "_get_layout"),
    ("torch._tensor", "_rebuild_from_type_v2"), ("numpy", "dtype"), ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
})
# torch._utils' rebuild functions that `torch.load(weights_only=True)`
# also takes
_REBUILD = frozenset({
    "_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_tensor_v3",
    "_rebuild_parameter", "_rebuild_parameter_with_state",
    "_rebuild_qtensor", "_rebuild_sparse_tensor", "_rebuild_nested_tensor",
    "_rebuild_meta_tensor_no_storage", "_rebuild_wrapper_subclass",
    "_rebuild_device_tensor_from_cpu_tensor",
    "_rebuild_device_tensor_from_numpy",
})


class _StandInType(type):
    """The type of the stand-in classes: calling one is refused."""

    def __call__(cls, *args, **kwargs):
        raise pickle.UnpicklingError(
            f"refusing to call {cls.__module__}.{cls.__qualname__}: the "
            "reference-checkpoint loader resolves only torch's rebuild "
            "functions and torch.nn classes (module docstring)")


class StandIn(metaclass=_StandInType):
    """An object of a class the loader does not resolve: the pickled
    state and nothing of the class. `__dict__` holds a dict state (a
    module's `_parameters`, `_buffers`, `_modules`, ...), `pickled_state`
    any other, `pickled_items` what a dict subclass (a config) carried."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["pickled_state"] = state

    def __setitem__(self, key, value):
        self.__dict__.setdefault("pickled_items", {})[key] = value


_STAND_INS: dict[tuple[str, str], type] = {}


def _stand_in(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STAND_INS:
        _STAND_INS[key] = _StandInType(name.rpartition(".")[2], (StandIn,),
                                       {"__module__": module,
                                        "__qualname__": name})
    return _STAND_INS[key]


def _python3_name(module: str, name: str) -> tuple[str, str]:
    """pickle's own mapping of Python 2 names (`__builtin__.set`,
    `copy_reg._reconstructor`) to Python 3 ones."""
    if (module, name) in _compat_pickle.NAME_MAPPING:
        return _compat_pickle.NAME_MAPPING[(module, name)]
    return _compat_pickle.IMPORT_MAPPING.get(module, module), name


def _resolvable(module: str, name: str) -> bool:
    if module == "builtins":
        return name in _BUILTINS
    if module == "torch._utils":
        return name in _REBUILD
    if (module, name) in _GLOBALS:
        return True
    if module == "torch":   # dtypes, layouts, memory formats, qschemes
        return isinstance(vars(torch).get(name),
                          (torch.dtype, torch.layout, torch.memory_format,
                           torch.qscheme))
    return False


class _Unpickler(pickle.Unpickler):
    """`pickle.Unpickler` that resolves the names of the module docstring
    and stands in for every other class."""

    def find_class(self, module, name):
        module, name = _python3_name(module, name)
        if _resolvable(module, name):
            return super().find_class(module, name)
        if module == "torch.nn" or module.startswith("torch.nn."):
            try:
                found = super().find_class(module, name)
            except (ImportError, AttributeError):
                found = None
            if isinstance(found, type) and issubclass(
                    found, (nn.Module, nn.Parameter)):
                return found
        return _stand_in(module, name)


def _load(file, **kwargs):
    return _Unpickler(file, **kwargs).load()


# what `torch.load(pickle_module=)` uses of a pickle module
_PICKLE_MODULE = types.SimpleNamespace(__name__="lgteun_reference_pickle",
                                       Unpickler=_Unpickler, load=_load)


def _is_module(obj) -> bool:
    return isinstance(obj, (nn.Module, StandIn)) and isinstance(
        vars(obj).get("_modules"), dict)


def _tensor(key: str, value) -> torch.Tensor:
    if not isinstance(value, torch.Tensor):
        raise ValueError(f"{key}: a {type(value).__name__}, not a tensor")
    return value.detach()


def module_state_dict(module, prefix: str = "") -> dict:
    """{dotted key: tensor} of a module or a stand-in of one, as
    `nn.Module.state_dict` walks it: parameters, persistent buffers,
    then each child."""
    d = vars(module)
    skip = d.get("_non_persistent_buffers_set", set())
    if not isinstance(skip, (set, frozenset)):
        raise ValueError(f"{prefix or 'the module'}: "
                         f"_non_persistent_buffers_set is a "
                         f"{type(skip).__name__}, not a set")
    out = {}
    for name, p in d.get("_parameters", {}).items():
        if p is not None:
            out[prefix + name] = _tensor(prefix + name, p)
    for name, b in d.get("_buffers", {}).items():
        if b is not None and name not in skip:
            out[prefix + name] = _tensor(prefix + name, b)
    for name, child in d["_modules"].items():
        if child is not None:
            out.update(module_state_dict(child, f"{prefix}{name}."))
    return out


def load_reference_checkpoint(path: str) -> tuple[dict, int]:
    """({module name: {key: tensor}}, iter_num) of a reference checkpoint
    (a pickle of whole modules, of state_dicts or one bare state_dict,
    zip or legacy format) on the CPU; iter_num 0 where it has none."""
    payload = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_PICKLE_MODULE)
    if not isinstance(payload, dict):
        raise ValueError(f"{path}: a {type(payload).__name__}, not a dict "
                         "of modules")
    payload = dict(payload)
    iter_num = int(payload.pop("iter_num", 0))
    if payload and all(isinstance(v, torch.Tensor)
                       for v in payload.values()):
        payload = {"core_module": payload}
    out = {}
    for name, entry in payload.items():
        if _is_module(entry):
            out[name] = module_state_dict(entry)
        elif isinstance(entry, dict):
            out[name] = {k: _tensor(f"{name}.{k}", v)
                         for k, v in entry.items()}
        else:
            raise ValueError(f"{path}: entry {name!r} is a "
                             f"{type(entry).__name__}, neither a module "
                             "nor a state_dict")
    return out, iter_num


def convert_reference_checkpoint(src: str, model_type: str, out: str,
                                 config: str | None = None) -> dict:
    """Write the Runner checkpoint of reference checkpoint `src` for
    `model_type` to `out` and return it. Raises on a module the method
    does not have; with `config` (a config file of `model_type`), on any
    key the method's modules do not load strictly."""
    if model_type not in REFERENCE_CLASSES:
        raise KeyError(f"no reference model {model_type!r}; available: "
                       f"{sorted(REFERENCE_CLASSES)}")
    modules, iter_num = load_reference_checkpoint(src)
    known = {"core_module", *AUX_CLASSES.get(model_type, {})}
    if "core_module" not in modules or set(modules) - known:
        raise ValueError(f"{src}: modules {sorted(modules)}; {model_type} "
                         f"checkpoints core_module and "
                         f"{sorted(known - {'core_module'}) or 'no other'}")
    if config is not None:
        from lgteun_tpu_torch.config import load_config
        from lgteun_tpu_torch.registry import build_model

        cfg = load_config(config)
        if cfg.model_type != model_type:
            raise ValueError(f"{config} is a {cfg.model_type} config, not "
                             f"{model_type}")
        method = build_model(model_type, cfg, device="cpu")
        for name, sd in modules.items():
            method.load_module_state_dict(name, sd, strict=True)
    payload = {"state_dict": modules["core_module"], "iter_num": iter_num}
    others = {k: v for k, v in modules.items() if k != "core_module"}
    if others:
        payload["modules"] = others
    torch.save(payload, out)
    return payload


def _torch_base(cls: type) -> type | None:
    """The first class of `cls`'s MRO from torch.nn other than Module."""
    for base in cls.__mro__:
        if base.__module__.startswith("torch.nn.") and base is not nn.Module:
            return base
    return None


def write_reference_checkpoint(path: str, modules: dict, iter_num: int,
                               model_type: str, cfg: dict | None = None,
                               legacy: bool = False) -> None:
    """Write {name: nn.Module} and `iter_num` as the reference saves a
    checkpoint (module docstring), from CPU copies: a class of the port
    that derives from a torch.nn class (a conv, a linear, a norm) is
    saved as that class; every other one as a class of the same name in
    the module file of the reference's class (`REFERENCE_CLASSES` for the
    core module, `AUX_CLASSES` for the others), declared in
    `sys.modules` for the time of the save only. The core module also
    holds `cfg` (as an object of a config class declared the same way)
    and a logger, as the reference's modules do; non-module attributes of
    the port's own classes are left out. `legacy`: torch's non-zip
    format."""
    declared: dict[str, types.ModuleType] = {}

    def declare(dotted: str, base=nn.Module) -> type:
        file, _, name = dotted.rpartition(".")
        parts = file.split(".")
        for i in range(1, len(parts) + 1):
            declared.setdefault(".".join(parts[:i]),
                                types.ModuleType(".".join(parts[:i])))
        mod = declared[file]
        if not hasattr(mod, name):
            setattr(mod, name, type(name, (base,), {"__module__": file,
                                                    "__qualname__": name}))
        return getattr(mod, name)

    payload = {}
    for name, module in modules.items():
        top = (REFERENCE_CLASSES[model_type] if name == "core_module"
               else AUX_CLASSES[model_type][name])
        file = top.rpartition(".")[0]
        copied = copy.deepcopy(module).cpu()
        for sub in copied.modules():
            cls = type(sub)
            if cls.__module__.startswith("torch."):
                continue
            for key, value in list(vars(sub).items()):
                if type(value).__module__.startswith("lgteun_tpu_torch"):
                    del sub.__dict__[key]
            base = _torch_base(cls)
            sub.__class__ = (base if base is not None else declare(
                top if sub is copied else f"{file}.{cls.__name__}"))
        if name == "core_module":
            copied.cfg = declare("mmcv.utils.config.ConfigDict",
                                 dict)(cfg or {})
            copied.logger = logging.getLogger(f"reference.{model_type}")
        payload[name] = copied
    payload["iter_num"] = iter_num
    previous = {k: sys.modules.get(k) for k in declared}
    sys.modules.update(declared)
    try:
        with warnings.catch_warnings():
            # the legacy format looks for the declared classes' sources
            warnings.simplefilter("ignore", UserWarning)
            torch.save(payload, path,
                       _use_new_zipfile_serialization=not legacy)
    finally:
        for key, mod in previous.items():
            if mod is None:
                sys.modules.pop(key, None)
            else:
                sys.modules[key] = mod


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m lgteun_tpu_torch.convert.from_reference",
        description="Convert a reference checkpoint (a pickle of whole "
                    "modules, or of state_dicts) into a Runner checkpoint "
                    "for `python -m lgteun_tpu_torch.main --checkpoint`.")
    parser.add_argument("--model-type", required=True,
                        choices=sorted(REFERENCE_CLASSES))
    parser.add_argument("--torch-ckpt", required=True,
                        help="the reference checkpoint (.pth)")
    parser.add_argument("--out", required=True,
                        help="the Runner checkpoint to write (.pt)")
    parser.add_argument("-c", "--config", default=None,
                        help="a config of the model: load every module "
                             "strictly before writing")
    args = parser.parse_args(argv)
    payload = convert_reference_checkpoint(args.torch_ckpt, args.model_type,
                                           args.out, args.config)
    n = sum(t.numel() for sd in [payload["state_dict"],
                                 *payload.get("modules", {}).values()]
            for t in sd.values())
    print(f"wrote {args.out} ({n:,} values, modules "
          f"{['core_module', *payload.get('modules', {})]}, iter "
          f"{payload['iter_num']})")


if __name__ == "__main__":
    main()
