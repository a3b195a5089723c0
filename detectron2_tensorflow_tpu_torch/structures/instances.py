"""Instances: a fixed-capacity, mask-validated container of per-object fields.

Port of the JAX package's ``structures/instances.py``. Every field
is a tensor whose leading dimensions are ``[B, capacity]`` (batched, as
``predict`` returns them) or ``[capacity]``; ``is_valid`` marks the live
slots. Capacities are static, so outputs compare slot by slot with the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch


class Instances:
    """A dict of tensors with a shared leading shape and a validity mask."""

    def __init__(self, **fields: Any):
        object.__setattr__(self, "_fields", dict(fields))

    def __getattr__(self, name: str) -> Any:
        fields = self.__dict__.get("_fields", {})
        if name in fields:
            return fields[name]
        raise AttributeError(f"Instances has no field '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self._fields[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def get_fields(self) -> Dict[str, Any]:
        return self._fields

    def replace(self, **updates: Any) -> "Instances":
        return Instances(**{**self._fields, **updates})

    def num_valid(self) -> torch.Tensor:
        """Count of live slots along the capacity axis."""
        return self._fields["is_valid"].sum(dim=-1)

    def gather(self, indices: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "Instances":
        """Gather slots of unbatched ``[capacity, ...]`` fields; AND in ``valid``."""
        out = {k: v[indices] for k, v in self._fields.items()}
        if valid is not None:
            out["is_valid"] = out["is_valid"] & valid if "is_valid" in out else valid
        return Instances(**out)

    @staticmethod
    def cat(instances: list["Instances"], dim: int = 0) -> "Instances":
        """Concatenate along the capacity axis."""
        keys = instances[0]._fields.keys()
        return Instances(
            **{k: torch.cat([i._fields[k] for i in instances], dim=dim) for k in keys}
        )

    def __repr__(self) -> str:
        fields = ", ".join(f"{k}: {tuple(v.shape)}" for k, v in self._fields.items())
        return f"Instances({fields})"
