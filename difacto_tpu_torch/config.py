"""Layered configuration (counterpart of difacto_tpu/config.py).

Config file + CLI ``k=v`` overrides -> flat key/value list -> each
component consumes the keys it declares and passes the remainder down
(the reference's ``dmlc::Parameter::InitAllowUnknown`` chain,
src/common/arg_parser.h:12-54). Leftover keys at the end of the chain are
a warning (src/main.cc:40-46). The grammar is the JAX package's, so the
same config files and CLI lines load in both.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, List, Tuple

log = logging.getLogger("difacto_tpu_torch")

KWArgs = List[Tuple[str, str]]


def parse_config_file(path: str) -> KWArgs:
    """``key = value`` lines, ``#`` comments; all pairs kept in order
    (consumers take the last)."""
    out: KWArgs = []
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"bad config line: {line!r}")
            k, v = line.split("=", 1)
            out.append((k.strip(), v.strip()))
    return out


def parse_cli_args(argv: List[str]) -> KWArgs:
    """CLI arguments: every token without ``=`` names a config file."""
    kwargs: KWArgs = []
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            kwargs.append((k.strip(), v.strip()))
        else:
            kwargs.extend(parse_config_file(a))
    return kwargs


def _coerce(value: str, ty: type) -> Any:
    if ty is bool:
        if isinstance(value, bool):
            return value
        v = str(value).lower()
        if v in ("1", "true", "yes"):
            return True
        if v in ("0", "false", "no"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    return ty(value)


@dataclass
class Param:
    """Typed parameter struct with range checks. Field metadata keys:
    ``lo``/``hi`` inclusive bounds, ``enum`` the allowed values."""

    @classmethod
    def init_allow_unknown(cls, kwargs: KWArgs) -> tuple["Param", KWArgs]:
        """Consume known keys from kwargs; return (instance, remainder)."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        taken: dict[str, Any] = {}
        remain: KWArgs = []
        for k, v in kwargs:
            f = fields.get(k)
            if f is None:
                remain.append((k, v))
                continue
            if isinstance(f.type, type):
                ty = f.type
            elif f.type in _FIELD_TYPES:
                ty = _FIELD_TYPES[f.type]
            else:
                raise TypeError(
                    f"{cls.__name__}.{f.name}: unsupported config field type "
                    f"{f.type!r}; use int/float/str/bool")
            taken[k] = _coerce(v, ty)  # last occurrence wins
        inst = cls(**taken)
        inst._validate()
        return inst, remain

    def _validate(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            lo = f.metadata.get("lo")
            hi = f.metadata.get("hi")
            enum = f.metadata.get("enum")
            if lo is not None and v < lo:
                raise ValueError(f"{f.name}={v} < {lo}")
            if hi is not None and v > hi:
                raise ValueError(f"{f.name}={v} > {hi}")
            if enum is not None and v not in enum:
                raise ValueError(f"{f.name}={v!r} not in {enum}")


# dataclass stores string annotations under `from __future__ import
# annotations`; map the common ones back to types
_FIELD_TYPES = {"int": int, "float": float, "str": str, "bool": bool}


def parse_endpoints(spec) -> List[Tuple[str, int]]:
    """``"h1:p1,h2:p2"`` (or a list of ``"h:p"`` strings / ``(h, p)``
    pairs) -> ``[(host, port), ...]``: the endpoint-list grammar of the
    failover client (serve/client.py) and the online loop's
    ``online_endpoints``."""
    parts = ([p for p in spec.split(",") if p.strip()]
             if isinstance(spec, str) else list(spec))
    out: List[Tuple[str, int]] = []
    for p in parts:
        if isinstance(p, (tuple, list)):
            host, port = p
        else:
            host, _, port = str(p).strip().rpartition(":")
            if not host:
                raise ValueError(
                    f"bad endpoint {p!r} (want host:port)")
        out.append((host, int(port)))
    if not out:
        raise ValueError(f"empty endpoint list: {spec!r}")
    return out


def format_endpoints(eps) -> str:
    """Inverse of :func:`parse_endpoints`: ``[(h, p), ...]`` ->
    ``"h1:p1,h2:p2"``."""
    return ",".join(f"{h}:{int(p)}" for h, p in parse_endpoints(eps))


def warn_unknown(remain: KWArgs) -> None:
    """Log unconsumed keys at the end of the config chain."""
    for k, v in remain:
        log.warning("unknown config key: %s = %s", k, v)
