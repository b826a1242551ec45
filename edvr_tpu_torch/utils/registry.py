"""Registries mapping YAML ``type:`` names to implementations.

The reference toolbox resolves YAML ``type`` fields by scanning package
folders and ``getattr``-ing modules (reference: basicsr/data/__init__.py:15-26,
basicsr/models/__init__.py:9-18, basicsr/models/archs/__init__.py:10-18).
Here we use explicit decorator-based registries with the same public
names, so the same option files resolve to the equivalent components.
"""

from __future__ import annotations


class Registry:
    """A simple name -> object registry.

    Objects register via decorator::

        @ARCH_REGISTRY.register()
        class EDVR(nn.Module): ...

    and are resolved by the YAML ``type`` string::

        cls = ARCH_REGISTRY.get('EDVR')
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict = {}

    def _do_register(self, name: str, obj) -> None:
        if name in self._obj_map:
            raise KeyError(
                f"'{name}' already registered in '{self._name}' registry")
        self._obj_map[name] = obj

    def register(self, obj=None, name: str | None = None):
        if obj is None:
            # used as a decorator (optionally with an explicit name)
            def deco(func_or_class):
                self._do_register(name or func_or_class.__name__,
                                  func_or_class)
                return func_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str):
        obj = self._obj_map.get(name)
        if obj is None:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}")
        return obj

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self):
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry('arch')
DATASET_REGISTRY = Registry('dataset')
MODEL_REGISTRY = Registry('model')
LOSS_REGISTRY = Registry('loss')
METRIC_REGISTRY = Registry('metric')
