"""Flatten and rebuild nested list/tuple/dict structures (counterpart
of ``libertem_tpu/executor/utils/delayed_unpack.py``), to carry
structured results through flat task graphs.

* ``flatten_nested`` walks depth first; an empty container gives one
  :class:`IgnoreClass` placeholder, so its place survives the round
  trip.
* ``build_mapping`` gives one path a flat element: a list of
  ``(container_type, key)`` hops; a bare (non-container) input maps to
  ``[None]``.
* ``rebuild_nested`` inverts the pair, container types included
  (tuples come back as tuples).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple


class IgnoreClass:
    """Placeholder for the contents of an empty container."""


_SEQ = (list, tuple)


def flatten_nested(el: Any) -> List[Any]:
    out: List[Any] = []
    if isinstance(el, _SEQ):
        if not el:
            return [IgnoreClass]
        for v in el:
            out.extend(flatten_nested(v))
    elif isinstance(el, dict):
        if not el:
            return [IgnoreClass]
        for v in el.values():
            out.extend(flatten_nested(v))
    else:
        out.append(el)
    return out


def build_mapping(
    el: Any, _prefix: Optional[List[Tuple[type, Any]]] = None,
) -> List[Optional[List[Tuple[type, Any]]]]:
    prefix = _prefix or []
    if isinstance(el, _SEQ):
        t = list if isinstance(el, list) else tuple
        if not el:
            return [prefix + [(t, IgnoreClass)]]
        out: List[Any] = []
        for i, v in enumerate(el):
            out.extend(build_mapping(v, prefix + [(t, i)]))
        return out
    if isinstance(el, dict):
        if not el:
            return [prefix + [(dict, IgnoreClass)]]
        out = []
        for k, v in el.items():
            out.extend(build_mapping(v, prefix + [(dict, k)]))
        return out
    return [prefix if prefix else None]


def rebuild_nested(flat: List[Any], mapping: List[Any]) -> Any:
    if mapping == [None]:
        return flat[0]
    return _rebuild(list(zip(flat, mapping)), 0)


def _rebuild(items, depth: int):
    container_t = items[0][1][depth][0]
    # group consecutive items by their key at this depth (paths are
    # emitted depth-first, so keys arrive grouped already)
    groups: List[Tuple[Any, list]] = []
    for value, path in items:
        key = path[depth][1]
        if groups and groups[-1][0] == key:
            groups[-1][1].append((value, path))
        else:
            groups.append((key, [(value, path)]))
    if len(groups) == 1 and groups[0][0] is IgnoreClass:
        return container_t()
    built = []
    for key, sub in groups:
        v0, p0 = sub[0]
        child = v0 if len(p0) == depth + 1 else _rebuild(sub, depth + 1)
        built.append((key, child))
    if container_t is dict:
        return {k: v for k, v in built}
    seq = [v for _, v in built]
    return tuple(seq) if container_t is tuple else seq
