"""Pluggable filtered-ANN method registry.

Methods register once (the six built-ins auto-register on first use;
new methods call `register_method`)
and every consumer resolves them through live *views*:
`candidate_methods()` is what the router selects among, `all_methods()`
additionally includes non-candidates such as the exact Pre-filter
baseline.
"""

from __future__ import annotations

from collections.abc import Mapping


class MethodRegistry:
    """Name -> Method instance, insertion-ordered, with a candidate flag."""

    def __init__(self):
        self._methods: dict[str, object] = {}
        self._candidate: dict[str, bool] = {}

    def register(self, method, *, candidate: bool = True,
                 overwrite: bool = False, name: str | None = None):
        name = name or getattr(method, "name", None)
        if not name or name == "?":
            raise ValueError("method must carry a non-empty .name "
                             "(or pass name= explicitly)")
        if name in self._methods and not overwrite:
            raise ValueError(
                f"method {name!r} is already registered; pass "
                f"overwrite=True to replace it")
        self._methods[name] = method
        self._candidate[name] = bool(candidate)
        return method

    def unregister(self, name: str) -> None:
        """Drop `name` (a no-op when it is not registered)."""
        self._methods.pop(name, None)
        self._candidate.pop(name, None)

    def get(self, name: str):
        try:
            return self._methods[name]
        except KeyError:
            raise KeyError(
                f"unknown method {name!r}; registered: "
                f"{sorted(self._methods)}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._methods

    def names(self, *, candidates_only: bool = False) -> list[str]:
        return [n for n in self._methods
                if not candidates_only or self._candidate[n]]

    def is_candidate(self, name: str) -> bool:
        return self._candidate.get(name, False)

    def view(self, *, candidates_only: bool = False) -> "RegistryView":
        return RegistryView(self, candidates_only=candidates_only)


class RegistryView(Mapping):
    """Live, read-only Mapping over a registry subset."""

    def __init__(self, registry: MethodRegistry, *, candidates_only: bool):
        self._registry = registry
        self._candidates_only = candidates_only

    def __getitem__(self, name: str):
        if self._candidates_only and not self._registry.is_candidate(name):
            raise KeyError(name)
        return self._registry.get(name)

    def __iter__(self):
        return iter(self._registry.names(
            candidates_only=self._candidates_only))

    def __len__(self) -> int:
        return len(self._registry.names(
            candidates_only=self._candidates_only))

    def __repr__(self) -> str:
        kind = "candidates" if self._candidates_only else "all"
        return f"RegistryView({kind}: {list(self)})"


_DEFAULT = MethodRegistry()
_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    """Import repro_torch.ann.methods once so the built-ins register."""
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        import repro_torch.ann.methods  # noqa: F401  (registers on import)
        _BUILTINS_LOADED = True


def default_registry() -> MethodRegistry:
    _ensure_builtins()
    return _DEFAULT


def register_method(method, *, candidate: bool = True,
                    overwrite: bool = False, name: str | None = None):
    """Register a Method instance in the default registry; returns it.
    Raises ValueError for a missing name or a duplicate without
    `overwrite=True`."""
    return _DEFAULT.register(method, candidate=candidate,
                             overwrite=overwrite, name=name)


def unregister_method(name: str) -> None:
    """Drop `name` from the default registry (a no-op when absent)."""
    _DEFAULT.unregister(name)


def get_method(name: str):
    return default_registry().get(name)


def serialize_index(method, index) -> dict | None:
    """Persistable array form of a built index (method name or
    instance): a dict of numpy arrays under the JAX package's keys when
    the method persists its index (`Method.index_arrays`), else None —
    the caller records the build key and rebuilds on load."""
    if isinstance(method, str):
        method = get_method(method)
    return method.index_arrays(index)


def deserialize_index(method, ds, build_params: dict, arrays: dict):
    """Restore a built index from `serialize_index` output (either
    package's); `build_params` as passed to `Method.build`."""
    if isinstance(method, str):
        method = get_method(method)
    return method.index_from_arrays(ds, dict(build_params), dict(arrays))


def candidate_methods() -> RegistryView:
    """Live view of the router's candidate pool."""
    return default_registry().view(candidates_only=True)


def all_methods() -> RegistryView:
    """Live view of every registered method (candidates + baselines)."""
    return default_registry().view()
