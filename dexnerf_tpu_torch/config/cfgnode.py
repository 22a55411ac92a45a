"""YACS-style configuration tree with attribute access.

Counterpart of ``dexnerf_tpu/config/cfgnode.py``, cut to what serving
needs: ``CfgNode.load_cfg`` from YAML, attribute access, ``dump`` and
``freeze``/``defrost``. YAML is parsed with PyYAML's ``safe_load``, as in
the JAX package, so ``configs/*.yml`` load to the same tree.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import yaml

_VALID_TYPES = {tuple, list, str, int, float, bool, type(None)}


class CfgNode(dict):
    """A dict subclass whose items are also attributes, recursively."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Optional[Dict] = None):
        tree = {}
        for k, v in copy.deepcopy(init_dict or {}).items():
            if isinstance(v, dict):
                v = CfgNode(v)
            elif type(v) not in _VALID_TYPES:
                raise ValueError(
                    f"invalid config value type {type(v)} for key {k}"
                )
            tree[k] = v
        super().__init__(tree)
        self.__dict__[CfgNode.IMMUTABLE] = False

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(
                f"attempted to set {name} on an immutable CfgNode"
            )
        self[name] = value

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def dump(self) -> str:
        """The tree as YAML (``yaml.safe_dump`` of plain dicts)."""

        def to_dict(node):
            return {k: to_dict(v) if isinstance(v, CfgNode) else v for k, v in node.items()}

        return yaml.safe_dump(to_dict(self))

    @classmethod
    def load_cfg(cls, cfg_file_obj_or_str) -> "CfgNode":
        """Load from a YAML string or an open YAML file."""
        return cls(yaml.safe_load(cfg_file_obj_or_str) or {})
