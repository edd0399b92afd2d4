"""Hydra-compatible configuration engine.

The port's own copy of ``deflow_tpu/config.py``, over its own ``conf/``.
It composes ``conf/config.yaml`` with a model group file
(``conf/model/deflow.yaml``) and ``key=value`` CLI overrides, the subset of
Hydra semantics the reference's CLI contract exercises:

- ``defaults:`` list in the primary config pulls group files in, nested under the
  group name (``model: deflow`` -> contents of ``conf/model/deflow.yaml`` under
  the ``model`` key).
- dotted CLI overrides (``model.target.num_iters=2``), group swaps
  (``model=fastflow3d``), YAML-typed values including lists
  (``voxel_size=[0.1, 0.2, 6]``), and ``+key=value`` for new keys.
- ``${path.to.key}`` interpolation resolved against the composed root.

Values are stored in :class:`Config`, a thin attribute/item-access wrapper
over a nested dict.  ``yaml`` is imported where a file or value is read.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Iterable, List, Optional

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
_CONF_DIR = os.path.join(os.path.dirname(__file__), "conf")


class ConfigError(Exception):
    pass


class Config:
    """Nested attribute-accessible config node."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- attribute protocol ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __eq__(self, other):
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self._data.items()}

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    # -- dotted-path helpers ----------------------------------------------------
    def select(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            elif isinstance(node, dict) and part in node:
                node = node[part]
            else:
                if default is ...:
                    raise ConfigError(f"missing config key: {path!r}")
                return default
        return node

    def update_path(self, path: str, value: Any, allow_new: bool = False) -> None:
        parts = path.split(".")
        node: Config = self
        for part in parts[:-1]:
            if part not in node:
                if not allow_new:
                    raise ConfigError(f"unknown config key: {path!r} (use +{path}= to add)")
                node[part] = {}
            nxt = node[part]
            if not isinstance(nxt, Config):
                raise ConfigError(f"cannot descend into non-dict key {part!r} of {path!r}")
            node = nxt
        leaf = parts[-1]
        if leaf not in node and not allow_new:
            raise ConfigError(f"unknown config key: {path!r} (use +{path}= to add)")
        node[leaf] = value


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    return value


def parse_value(text: str) -> Any:
    """Parse a CLI override value with Hydra-like typing.

    YAML gives us bools/ints/lists; scientific notation like ``2e-4`` is a string
    under YAML 1.1, so fall back to numeric coercion (Hydra treats it as float,
    cf. reference README.md:66 ``lr=2e-4``).
    """
    import yaml

    if text == "":
        return ""
    try:
        val = yaml.safe_load(text)
    except yaml.YAMLError:
        val = text
    if isinstance(val, str):
        try:
            return int(val)
        except ValueError:
            pass
        try:
            return float(val)
        except ValueError:
            pass
        if val.lower() in ("null", "none"):
            return None
    return val


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"config file {path} must contain a mapping")
    return data


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _split_overrides(overrides: Iterable[str]):
    """Split CLI overrides into (group swaps, dotted key/value pairs)."""
    groups: Dict[str, str] = {}
    kvs: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        key = key.strip()
        allow_new = key.startswith("+")
        if allow_new:
            key = key[1:]
        kvs.append((key, parse_value(raw.strip()), allow_new))
    for key, val, allow_new in list(kvs):
        # a bare group name matching a conf/<group>/ dir is a group swap
        if "." not in key and isinstance(val, str) and not allow_new:
            groups.setdefault(key, val)
    return groups, kvs


def _resolve_interpolations(root: Dict[str, Any]) -> None:
    def resolve(value: Any, seen: tuple) -> Any:
        if isinstance(value, str):
            matches = _INTERP_RE.findall(value)
            if not matches:
                return value
            # full-string interpolation keeps the referenced type
            full = _INTERP_RE.fullmatch(value.strip())
            if full:
                ref = full.group(1)
                if ref in seen:
                    raise ConfigError(f"interpolation cycle at ${{{ref}}}")
                return resolve(_select(root, ref), seen + (ref,))

            def sub(m):
                ref = m.group(1)
                if ref in seen:
                    raise ConfigError(f"interpolation cycle at ${{{ref}}}")
                return str(resolve(_select(root, ref), seen + (ref,)))

            return _INTERP_RE.sub(sub, value)
        if isinstance(value, dict):
            return {k: resolve(v, seen) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, seen) for v in value]
        return value

    for k in list(root.keys()):
        root[k] = resolve(root[k], ())


def _select(root: Dict[str, Any], path: str) -> Any:
    node: Any = root
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            raise ConfigError(f"interpolation target not found: {path!r}")
        node = node[part]
    return node


def compose(
    config_name: str = "config",
    overrides: Optional[Iterable[str]] = None,
    config_dir: Optional[str] = None,
) -> Config:
    """Compose a config the way the reference's Hydra entry points do.

    ``compose("config", ["model=deflow", "lr=2e-4", "model.target.num_iters=2"])``
    mirrors ``python train.py model=deflow lr=2e-4 "model.target.num_iters=2"``
    (reference assets/slurm/1_train.sh:42).
    """
    config_dir = config_dir or _CONF_DIR
    overrides = list(overrides or [])
    primary = _load_yaml(os.path.join(config_dir, config_name + ".yaml"))

    defaults = primary.pop("defaults", [])
    group_swaps, kvs = _split_overrides(overrides)

    composed: Dict[str, Any] = {}
    for entry in defaults:
        if entry == "_self_":
            _merge(composed, primary)
            continue
        if isinstance(entry, dict):
            [(group, name)] = entry.items()
        else:
            group, name = entry, None
        if group in group_swaps:
            name = group_swaps[group]
        group_path = os.path.join(config_dir, group, f"{name}.yaml")
        if not os.path.exists(group_path):
            raise ConfigError(f"unknown {group} config: {name!r} ({group_path} not found)")
        composed[group] = _load_yaml(group_path)
    if "_self_" not in defaults:
        _merge(composed, primary)

    cfg = Config(composed)
    for key, val, allow_new in kvs:
        if key in group_swaps and group_swaps[key] == val and os.path.isdir(os.path.join(config_dir, key)):
            continue  # already applied as a group swap
        cfg.update_path(key, val, allow_new=allow_new)

    resolved = cfg.to_dict()
    _resolve_interpolations(resolved)
    return Config(resolved)


def from_cli(argv: Optional[List[str]] = None, config_name: str = "config") -> Config:
    """Build a config from ``sys.argv``-style ``key=value`` overrides."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    return compose(config_name=config_name, overrides=args)


def check_num_devices(cfg, world: int) -> None:
    """``num_devices`` keeps the JAX package's meaning: -1 (or 0) takes
    every device, here every rank the launcher started (``world``); any
    other value must equal ``world``, or this raises ``ValueError``."""
    n = int(cfg.get("num_devices", -1))
    if n > 0 and n != world:
        raise ValueError(f"num_devices={n}, but the launcher started {world} ranks "
                         "(torchrun --nproc_per_node); -1 takes them all")
