"""Typed declarative run configuration (the port's copy of
``repro.config.gsconfig``, trimmed to what serving node classification
reads).

One mapping drives the run: ``gnn``, ``hyperparam``, ``input``,
``output``, ``node_classification`` and ``serve`` sections, loaded from
a dict, a JSON file or a YAML file with strict unknown-key rejection,
per-field type coercion, defaults and cross-field validation.  YAML is
parsed only when a ``.yaml``/``.yml`` path is given (``import yaml`` is
lazy), so dicts and JSON work without PyYAML installed.

A ``config.json`` persisted next to a checkpoint by the reference
package loads unchanged: keys that only its training pipeline acts on
(data parallelism, sharded tables, epoch streaming) are accepted and
carried, but serving does not read them.
"""
from __future__ import annotations

import dataclasses
import difflib
import json
from typing import Any, Dict, List, Optional, Tuple

# Built-in synthetic dataset families and their default prediction
# targets: dataset -> (target ntype, target etype, num classes).
DATASET_TARGETS = {
    "mag": ("paper", ("paper", "cites", "paper"), 8),
}

TASK_KINDS = ("node_classification",)
MODEL_KINDS = ("rgcn",)
PART_METHODS = ("random", "ldg", "metis")


class ConfigError(ValueError):
    """A configuration problem, with the dotted path of the offending key."""


def _err(path: str, msg: str) -> ConfigError:
    where = f"config key '{path}'" if path else "config"
    return ConfigError(f"{where}: {msg}")


# ---------------------------------------------------------------------------
# generic dict <-> dataclass machinery
# ---------------------------------------------------------------------------
def _coerce(value, field: dataclasses.Field, path: str):
    """Coerce a raw YAML/JSON value to the field's declared type."""
    kind = field.metadata.get("kind", "raw")
    if value is None:
        if field.metadata.get("optional", False):
            return None
        raise _err(path, "must not be null")
    if kind == "int":
        if isinstance(value, bool) or not isinstance(value, int):
            raise _err(path, f"expected an integer, got {value!r}")
        return value
    if kind == "float":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise _err(path, f"expected a number, got {value!r}")
        return float(value)
    if kind == "bool":
        if not isinstance(value, bool):
            raise _err(path, f"expected true/false, got {value!r}")
        return value
    if kind == "str":
        if not isinstance(value, str):
            raise _err(path, f"expected a string, got {value!r}")
        choices = field.metadata.get("choices")
        if choices and value not in choices:
            raise _err(path, f"{value!r} is not one of {list(choices)}")
        return value
    if kind == "int_list":
        if not isinstance(value, (list, tuple)) or not value or \
                any(isinstance(v, bool) or not isinstance(v, int)
                    for v in value):
            raise _err(path, f"expected a non-empty list of integers, "
                             f"got {value!r}")
        return list(value)
    if kind == "dict":
        if not isinstance(value, dict):
            raise _err(path, f"expected a mapping, got {value!r}")
        return dict(value)
    if kind == "section":
        return _from_dict(field.metadata["cls"], value, path)
    return value


def _from_dict(cls, d, path: str = ""):
    if not isinstance(d, dict):
        raise _err(path or cls.__name__, f"expected a mapping, got {d!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        key = sorted(unknown)[0]
        hint = difflib.get_close_matches(key, fields, n=1)
        hint_s = f" (did you mean {hint[0]!r}?)" if hint else ""
        raise _err(f"{path}.{key}" if path else key,
                   f"unknown key in section "
                   f"'{path or 'top level'}'{hint_s}; valid keys: "
                   f"{sorted(fields)}")
    kw = {}
    for name, f in fields.items():
        if name in d:
            kw[name] = _coerce(d[name], f,
                               f"{path}.{name}" if path else name)
        elif f.default is dataclasses.MISSING and \
                f.default_factory is dataclasses.MISSING:
            raise _err(f"{path}.{name}" if path else name,
                       f"required key missing from section "
                       f"'{path or 'top level'}'")
    return cls(**kw)


def _to_plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if getattr(obj, f.name) is not None}
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    return obj


def _field(kind: str, default=dataclasses.MISSING, *, optional=False,
           choices=None, cls=None, default_factory=dataclasses.MISSING):
    md: Dict[str, Any] = {"kind": kind, "optional": optional}
    if choices:
        md["choices"] = choices
    if cls is not None:
        md["cls"] = cls
    return dataclasses.field(default=default, default_factory=default_factory,
                             metadata=md)


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GnnConfig:
    """Encoder architecture."""
    model: str = _field("str", "rgcn", choices=MODEL_KINDS)
    hidden: int = _field("int", 64)
    num_layers: int = _field("int", 2)
    fanout: List[int] = _field("int_list", default_factory=lambda: [8, 8])
    nheads: int = _field("int", 4)
    # embedding dim for featureless node types (sparse embedding tables)
    sparse_embed_dim: int = _field("int", 16)
    # kernel routing of the reference package; the port routes by
    # device instead (CUDA tensors launch the kernels, CPU tensors take
    # the plain versions), so these two are carried and not read
    use_pallas: bool = _field("bool", False)
    pallas_interpret: bool = _field("bool", True)


@dataclasses.dataclass
class HyperparamConfig:
    lr: float = _field("float", 1e-2)
    batch_size: int = _field("int", 256)
    num_epochs: int = _field("int", 5)
    # seeds the graph, the sampler's counter-based stream, the weight
    # init and the synthetic request stream
    seed: int = _field("int", 0)
    # training-pipeline keys of the reference package, carried so its
    # persisted configs load; serving always samples on the device, on
    # one device, with replicated tables
    prefetch: int = _field("int", 2)
    sample_on_device: bool = _field("bool", False)
    data_parallel: int = _field("int", 1)
    shard_tables: bool = _field("bool", False)
    shard_gather: str = _field("str", "alltoall",
                               choices=("alltoall", "gspmd"))
    remote_prefetch: int = _field("int", 1)
    shard_dedup: bool = _field("bool", False)
    shard_payload_dtype: str = _field("str", "float32",
                                      choices=("float32", "bfloat16"))
    epoch_chunks: int = _field("int", 1)
    eval_on_device: bool = _field("bool", False)
    async_checkpoint: bool = _field("bool", False)


@dataclasses.dataclass
class InputConfig:
    """Where the graph comes from: a built-in synthetic family."""
    dataset: Optional[str] = _field("str", None, optional=True,
                                    choices=tuple(DATASET_TARGETS))
    dataset_conf: Dict[str, Any] = _field("dict", default_factory=dict)
    # graph construction from raw tables is not ported yet; the key is
    # accepted so the validation below can name it
    gconstruct_conf: Optional[Any] = _field("raw", None, optional=True)
    num_parts: int = _field("int", 1)
    part_method: str = _field("str", "random", choices=PART_METHODS)
    save_graph_path: Optional[str] = _field("str", None, optional=True)
    label_field: str = _field("str", "label")
    feat_field: str = _field("str", "feat")


@dataclasses.dataclass
class OutputConfig:
    save_model_path: Optional[str] = _field("str", None, optional=True)
    save_embed_path: Optional[str] = _field("str", None, optional=True)
    restore_model_path: Optional[str] = _field("str", None, optional=True)


@dataclasses.dataclass
class NodeClassificationConfig:
    # both default from DATASET_TARGETS when input.dataset is built-in
    target_ntype: Optional[str] = _field("str", None, optional=True)
    num_classes: Optional[int] = _field("int", None, optional=True)


@dataclasses.dataclass
class ServeConfig:
    """Batched inference serving (``gs --serve``): continuous batching
    into the device program's static batch shape plus a device-resident,
    staleness-bounded embedding cache."""
    # serving batch size (the static program shape); defaults to
    # hyperparam.batch_size
    batch_size: Optional[int] = _field("int", None, optional=True)
    # device-resident LRU cache slots; 0 disables the cache (every
    # batch recomputes — the cold-path / parity-reference behavior)
    cache_slots: int = _field("int", 4096)
    # a cached row older than this many program steps is recomputed
    max_staleness_steps: int = _field("int", 64)
    # replicas, HTTP front end, admission control and cache persistence
    # are not ported yet: only their defaults are accepted
    num_replicas: int = _field("int", 1)
    port: Optional[int] = _field("int", None, optional=True)
    max_pending_rows: int = _field("int", 0)
    priorities: Dict[str, float] = \
        _field("dict", default_factory=lambda: {"high": 1.0, "low": 0.5})
    persist_cache: bool = _field("bool", False)
    # synthetic request stream of the CLI path (see serve.request_stream)
    requests: int = _field("int", 64)
    request_size: int = _field("int", 4)
    hot_fraction: float = _field("float", 0.8)
    hot_set: int = _field("int", 64)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GSConfig:
    task: str = _field("str", choices=TASK_KINDS)
    version: str = _field("str", "gsconfig-v1")
    gnn: GnnConfig = _field("section", cls=GnnConfig,
                            default_factory=GnnConfig)
    hyperparam: HyperparamConfig = _field("section", cls=HyperparamConfig,
                                          default_factory=HyperparamConfig)
    input: InputConfig = _field("section", cls=InputConfig,
                                default_factory=InputConfig)
    output: OutputConfig = _field("section", cls=OutputConfig,
                                  default_factory=OutputConfig)
    node_classification: Optional[NodeClassificationConfig] = \
        _field("section", None, optional=True, cls=NodeClassificationConfig)
    serve: Optional[ServeConfig] = \
        _field("section", None, optional=True, cls=ServeConfig)
    # feature tables are device-resident; serving always uses them
    device_features: bool = _field("bool", False)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GSConfig":
        cfg = _from_dict(cls, d)
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str,
                  overrides: Optional[List[str]] = None) -> "GSConfig":
        raw = load_config_dict(path)
        if overrides:
            raw = apply_overrides(raw, overrides)
        return cls.from_dict(raw)

    def to_dict(self) -> Dict[str, Any]:
        return _to_plain(self)

    # ------------------------------------------------------------------
    def validate(self):
        g, h, inp = self.gnn, self.hyperparam, self.input
        if len(g.fanout) != g.num_layers:
            raise _err("gnn.fanout",
                       f"needs one entry per GNN layer: got {g.fanout} "
                       f"for gnn.num_layers={g.num_layers}")
        if any(f <= 0 for f in g.fanout):
            raise _err("gnn.fanout",
                       f"fanouts must be positive, got {g.fanout}")
        for key in ("hidden", "num_layers", "sparse_embed_dim"):
            if getattr(g, key) <= 0:
                raise _err(f"gnn.{key}", "must be positive")
        for key in ("batch_size", "num_epochs"):
            if getattr(h, key) <= 0:
                raise _err(f"hyperparam.{key}", "must be positive")
        if h.lr <= 0:
            raise _err("hyperparam.lr", "must be positive")
        if self.serve is not None:
            sv = self.serve
            if sv.batch_size is not None and sv.batch_size <= 0:
                raise _err("serve.batch_size", "must be positive")
            if sv.cache_slots < 0:
                raise _err("serve.cache_slots",
                           "must be >= 0 (0 disables the cache)")
            if sv.max_staleness_steps < 0:
                raise _err("serve.max_staleness_steps", "must be >= 0")
            for key in ("requests", "request_size", "hot_set"):
                if getattr(sv, key) <= 0:
                    raise _err(f"serve.{key}", "must be positive")
            if not 0.0 <= sv.hot_fraction <= 1.0:
                raise _err("serve.hot_fraction", "must be in [0, 1]")
            unported = {"num_replicas": (sv.num_replicas, 1),
                        "port": (sv.port, None),
                        "max_pending_rows": (sv.max_pending_rows, 0),
                        "persist_cache": (sv.persist_cache, False)}
            for key, (val, default) in unported.items():
                if val != default:
                    raise _err(f"serve.{key}",
                               f"only the default ({default!r}) is "
                               f"supported by the port so far")
        if inp.gconstruct_conf is not None:
            raise _err("input.gconstruct_conf",
                       "graph construction is not ported yet; use "
                       "input.dataset")
        if inp.dataset is None:
            raise _err("input.dataset",
                       "must name a built-in synthetic family "
                       f"({sorted(DATASET_TARGETS)})")
        if getattr(self, self.task) is None:
            raise _err(self.task,
                       f"task '{self.task}' requires a '{self.task}' "
                       f"section (add one, even if empty, to opt in)")

    # ------------------------------------------------------------------
    def resolved(self) -> "GSConfig":
        """Fill task-target defaults from the built-in dataset table
        (e.g. dataset 'mag' -> target_ntype 'paper', 8 classes)."""
        cfg = dataclasses.replace(self)
        target = DATASET_TARGETS.get(cfg.input.dataset or "")
        nc = dataclasses.replace(cfg.node_classification)
        if target:
            nc.target_ntype = nc.target_ntype or target[0]
            nc.num_classes = nc.num_classes or target[2]
        if nc.target_ntype is None or nc.num_classes is None:
            raise _err("node_classification",
                       "target_ntype/num_classes must be set when "
                       "input.dataset is not a built-in family")
        cfg.node_classification = nc
        return cfg


# ---------------------------------------------------------------------------
# file loading + CLI overrides
# ---------------------------------------------------------------------------
def load_config_dict(path: str) -> Dict[str, Any]:
    """Read a YAML or JSON config file into a plain dict.  PyYAML is
    imported only for ``.yaml``/``.yml`` files."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml
        raw = yaml.safe_load(text)
    else:
        raw = json.loads(text)
    if not isinstance(raw, dict):
        raise ConfigError(f"config file {path!r} must contain a mapping, "
                          f"got {type(raw).__name__}")
    return raw


def _parse_scalar(text: str):
    """Parse an override value as JSON ('8,8' -> [8, 8], 'true' ->
    True, '0.5' -> 0.5); anything that is not JSON stays a string."""
    if "," in text and not text.strip().startswith(("[", "{")):
        text = f"[{text}]"
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def apply_overrides(raw: Dict[str, Any],
                    overrides: List[str]) -> Dict[str, Any]:
    """Apply CLI overrides to a raw config dict.

    Accepts ``--gnn.hidden 128`` pairs and ``gnn.hidden=128`` tokens;
    dotted paths address nested sections.  Typos surface as unknown-key
    errors when the dict is loaded.
    """
    raw = json.loads(json.dumps(raw))  # deep copy
    pairs: List[Tuple[str, Any]] = []
    i = 0
    while i < len(overrides):
        tok = overrides[i]
        if "=" in tok:
            key, _, val = tok.lstrip("-").partition("=")
            pairs.append((key, _parse_scalar(val)))
            i += 1
        elif tok.startswith("--"):
            if i + 1 >= len(overrides):
                raise ConfigError(f"override {tok!r} is missing a value")
            pairs.append((tok[2:].replace("-", "_"),
                          _parse_scalar(overrides[i + 1])))
            i += 2
        else:
            raise ConfigError(
                f"cannot parse override {tok!r}: use '--section.key value' "
                f"or 'section.key=value'")
    for key, val in pairs:
        parts = key.split(".")
        node = raw
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ConfigError(f"override {key!r}: '{p}' is not a "
                                  f"section")
        node[parts[-1]] = val
    return raw
