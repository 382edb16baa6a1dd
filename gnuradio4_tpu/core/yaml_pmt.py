"""Reference-compatible typed YAML for property maps (≈ core YamlPmt.hpp,
exercised by qa_YamlPmt.cpp).

The reference serializes ``property_map``/pmt values with YAML type tags —
``!!int8 … !!uint64``, ``!!float32/64``, ``!!complex32/64 (re, im)``,
``!!bool``, ``!!str``, ``!!null`` — on scalars AND on sequences (tagging the
element type). This module makes that dialect load and emit here, so YAML
written by the reference round-trips with exact dtypes:

- typed scalars/vectors land as numpy scalars/arrays of the tagged dtype
  (complex ``(re, im)`` tuples included);
- untagged scalars follow the reference's inference (int64 for integers incl.
  0x/0o/0b spellings, float64 with .inf/.nan forms, true/false/null families);
- tagged values are validated with positioned errors (range-checked integers,
  strict bool spellings, well-formed complex pairs) — GrError like the
  reference's parse errors (qa_YamlPmt.cpp:469-580).
"""

from __future__ import annotations

import re
from typing import Any

import functools

import numpy as np

from .errors import GrError

_INT_TAGS = {f"{s}{w}": np.dtype(f"{s}{w}")
             for s in ("int", "uint") for w in (8, 16, 32, 64)}
_FLOAT_TAGS = {"float32": np.dtype("float32"), "float64": np.dtype("float64")}
_COMPLEX_TAGS = {"complex32": np.dtype("complex64"),     # reference naming:
                 "complex64": np.dtype("complex128")}    # bits per COMPONENT
_COMPLEX_RE = re.compile(r"^\(\s*([^,()\s][^,()]*?)\s*,\s*([^,()\s][^,()]*?)"
                         r"\s*\)$")


def _mark(node) -> str:
    m = node.start_mark
    return f"{m.line + 1}:{m.column + 1}"


def _parse_int(s: str, dtype: np.dtype, node) -> Any:
    t = s.strip().replace("_", "")
    try:
        v = int(t, 0)      # accepts 0x / 0o / 0b / decimal with sign
    except ValueError:
        raise GrError(f"Error in {_mark(node)}: Invalid integral-type "
                      f"value {t!r}")
    info = np.iinfo(dtype)
    if not info.min <= v <= info.max:
        raise GrError(f"Error in {_mark(node)}: Invalid integral-type value "
                      f"{t!r} (out of range for {dtype})")
    return dtype.type(v)


_FLOAT_SPECIALS = {".inf": np.inf, ".Inf": np.inf, ".INF": np.inf,
                   "-.inf": -np.inf, "-.Inf": -np.inf, "-.INF": -np.inf,
                   ".nan": np.nan, ".NaN": np.nan, ".NAN": np.nan}


def _parse_float(s: str, dtype: np.dtype, node) -> Any:
    t = s.strip()
    if t in _FLOAT_SPECIALS:
        return dtype.type(_FLOAT_SPECIALS[t])
    try:
        return dtype.type(float(t))
    except ValueError:
        raise GrError(f"Error in {_mark(node)}: expected floating-point "
                      f"value of {t!r}")


def _parse_complex(s: str, dtype: np.dtype, node) -> Any:
    m = _COMPLEX_RE.match(s.strip())
    if not m:
        raise GrError(f"Error in {_mark(node)}: Invalid value for "
                      f"complex<>-type")
    try:
        re_, im_ = float(m.group(1)), float(m.group(2))
    except ValueError as e:
        raise GrError(f"Error in {_mark(node)}: expected floating-point "
                      f"value — {e}")
    return dtype.type(complex(re_, im_))


def _parse_bool(s: str, node) -> bool:
    if s == "true":
        return True
    if s == "false":
        return False
    raise GrError(f"Error in {_mark(node)}: Invalid value for bool-type")


def _scalar_for(tag: str):
    def build(loader, node, _tag=tag):
        import yaml
        if isinstance(node, yaml.SequenceNode):
            # a numeric element tag on an item of an already-typed list is
            # the reference's "Cannot have type tag for both list and list
            # item" error (qa_YamlPmt.cpp:698) — detectable here only for
            # tags that plain scalars never resolve to implicitly
            for child in node.value:
                own = child.tag.rsplit(":", 1)[-1]
                if isinstance(child, yaml.ScalarNode) and own != _tag \
                        and own in (_ALL_TAGS - {"str", "bool", "null"}):
                    raise GrError(f"Error in {_mark(child)}: Cannot have "
                                  f"type tag for both list and list item")
            items = [_scalar_value(loader, c, _tag) for c in node.value]
            if _tag in _INT_TAGS or _tag in _FLOAT_TAGS \
                    or _tag in _COMPLEX_TAGS:
                dt = (_INT_TAGS.get(_tag) or _FLOAT_TAGS.get(_tag)
                      or _COMPLEX_TAGS.get(_tag))
                return np.asarray(items, dtype=dt)
            if _tag == "bool":
                return np.asarray(items, dtype=bool)
            if _tag == "null":
                return None      # a null-tagged vector collapses to null
            return items          # !!str sequences → plain string lists
        return _scalar_value(loader, node, _tag)

    return build


def _scalar_value(loader, node, tag: str) -> Any:
    import yaml
    if isinstance(node, yaml.SequenceNode):
        return [_scalar_value(loader, c, tag) for c in node.value]
    if isinstance(node, yaml.MappingNode):
        return loader.construct_mapping(node, deep=True)
    s = str(node.value)
    # inside a typed sequence the sequence's element tag always wins — the
    # reference rejects explicit per-item tags in typed lists outright
    # (qa_YamlPmt.cpp:698), so there is no valid case where an item tag
    # should override (explicit vs implicitly-resolved tags are
    # indistinguishable after compose)
    if tag in _INT_TAGS:
        return _parse_int(s, _INT_TAGS[tag], node)
    if tag in _FLOAT_TAGS:
        return _parse_float(s, _FLOAT_TAGS[tag], node)
    if tag in _COMPLEX_TAGS:
        return _parse_complex(s, _COMPLEX_TAGS[tag], node)
    if tag == "bool":
        # untagged bools resolved by yaml already carry the bool tag with
        # canonical spellings; an explicit !!bool is strict (cpp:468-473)
        if node.tag == "tag:yaml.org,2002:bool" and s in (
                "true", "false", "True", "False", "TRUE", "FALSE"):
            return s.lower() == "true"
        return _parse_bool(s, node)
    if tag == "null":
        return None              # "!!null anything" → null (cpp:419)
    return s                     # !!str


_ALL_TAGS = (set(_INT_TAGS) | set(_FLOAT_TAGS) | set(_COMPLEX_TAGS)
             | {"bool", "str", "null"})

@functools.lru_cache(maxsize=1)
def _pmt_loader():
    """The typed SafeLoader, built at first use: PyYAML is an optional
    dependency that only YAML flowgraph and PMT I/O needs."""
    import yaml

    class _PmtLoader(yaml.SafeLoader):
        pass

    for t in _ALL_TAGS:
        _PmtLoader.add_constructor(f"tag:yaml.org,2002:{t}", _scalar_for(t))
    # untagged 0o77 / 0b1010 integers (the reference accepts them untagged as
    # int64; PyYAML's 1.1 resolver misses the 0o spelling)
    _PmtLoader.add_implicit_resolver(
        "tag:yaml.org,2002:int", re.compile(r"^[-+]?0o[0-7]+$"), list("-+0"))
    return _PmtLoader


def _post(v: Any) -> Any:
    """Normalize container keys; scalar typing is fully handled by the
    constructors + the 0o implicit resolver above (coercing octal-looking
    STRINGS here would corrupt quoted/!!str values and break the dump→load
    fixpoint)."""
    if isinstance(v, dict):
        return {str(k): _post(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_post(x) for x in v]
    return v


def load(text: str) -> dict[str, Any]:
    """Parse reference-dialect YAML into a property map."""
    import yaml
    try:
        data = yaml.load(text, Loader=_pmt_loader())   # noqa: S506 — SafeLoader
    except yaml.YAMLError as e:
        raise GrError(f"YAML parse error: {e}")
    return _post(data) if isinstance(data, dict) else (_post(data) or {})


# -- serialization ----------------------------------------------------------------

_NP_TAG = {np.dtype(f"{s}{w}"): f"!!{s}{w}"
           for s in ("int", "uint") for w in (8, 16, 32, 64)}
_NP_TAG[np.dtype("float32")] = "!!float32"
_NP_TAG[np.dtype("complex64")] = "!!complex32"
_NP_TAG[np.dtype("complex128")] = "!!complex64"
# int64 / float64 are the untagged defaults (reference inference types)
_UNTAGGED = {np.dtype("int64"), np.dtype("float64"), np.dtype("bool")}


def _fmt_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (complex, np.complexfloating)):
        return f"({np.real(v)}, {np.imag(v)})"
    if isinstance(v, (float, np.floating)):
        f = float(v)
        if np.isnan(f):
            return ".nan"
        if np.isinf(f):
            return ".inf" if f > 0 else "-.inf"
        return repr(f)
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    s = str(v)
    if s == "" or s != s.strip() or any(c in s for c in ":#{}[]\n'\"") \
            or s.lower() in ("null", "true", "false", "~") \
            or re.match(r"^[-+.\d]", s):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n") + '"'
    return s


def _tag_of(v: Any) -> str:
    if isinstance(v, np.ndarray):
        return _NP_TAG.get(v.dtype, "")
    if isinstance(v, np.generic) and not isinstance(v, np.bool_):
        return _NP_TAG.get(np.dtype(type(v)), "")
    if isinstance(v, complex):
        return "!!complex64"
    return ""


def _emit(v: Any, indent: int, out: list[str], key: str | None = None) -> None:
    pad = "  " * indent
    head = f"{pad}{key}:" if key is not None else f"{pad}-"
    tag = _tag_of(v)
    if isinstance(v, dict):
        if not v:
            out.append(f"{head} {{}}")
            return
        out.append(head)
        for k, x in v.items():
            _emit(x, indent + 1, out, key=str(k))
    elif isinstance(v, np.ndarray) and v.ndim == 1 or isinstance(v, (list,
                                                                     tuple)):
        items = list(v)
        if not items:
            out.append(f"{head} {tag + ' ' if tag else ''}[]")
            return
        out.append(f"{head}{' ' + tag if tag else ''}")
        for x in items:
            if isinstance(x, (dict, list, tuple)) or \
                    (isinstance(x, np.ndarray) and x.ndim == 1):
                _emit(x, indent + 1, out)
            else:
                item_tag = "" if tag else _tag_of(x)
                out.append(f"{pad}  - "
                           f"{item_tag + ' ' if item_tag else ''}"
                           f"{_fmt_scalar(x)}")
    else:
        out.append(f"{head} {tag + ' ' if tag else ''}{_fmt_scalar(v)}")


def dump(pmap: dict[str, Any]) -> str:
    """Serialize a property map in the reference's tagged-YAML dialect."""
    out: list[str] = []
    for k, v in pmap.items():
        _emit(v, 0, out, key=str(k))
    return "\n".join(out) + "\n"
