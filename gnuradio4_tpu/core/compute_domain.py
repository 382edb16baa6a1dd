"""ComputeDomain — device-placement descriptor (≈ reference core
ComputeDomain.hpp:16-60: {kind, access, backend, deviceIndex, tag}, parse
"kind:backend:idx"; consumed per-Edge/per-Port).

The natural domains are:

- ``gpu`` (default): the block's apply is traced into the fused device program;
- ``host``: the block runs on the host (sinks/sources/HostBlock — anything with
  FEED/HOST_TAP/consume);
- a mesh axis placement for sharded execution (``gpu:mesh:<axis>``).

``fpga`` parses, for parity with the reference, but no block runs there.

The descriptor is carried on edges (Graph.connect(..., domain=...)) and exposed
through introspection; the compiler currently derives actual placement from
block structure (FEED/SinkBlock/HOST_TAP), with the descriptor as the
user-visible annotation + validation point.
"""

from __future__ import annotations

import dataclasses
import enum

from .errors import GrError


class DomainKind(enum.Enum):
    HOST = "host"
    GPU = "gpu"
    FPGA = "fpga"


class Access(enum.Enum):
    HOST_ONLY = "HostOnly"
    SHARED = "Shared"
    DEVICE_ONLY = "DeviceOnly"


@dataclasses.dataclass(frozen=True)
class ComputeDomain:
    kind: DomainKind = DomainKind.GPU
    backend: str = "xla"
    device_index: int = 0
    access: Access = Access.SHARED
    tag: str = ""

    @classmethod
    def parse(cls, spec: str) -> "ComputeDomain":
        """Parse "kind[:backend[:idx]]" (≈ ComputeDomain.hpp:50)."""
        parts = str(spec).split(":")
        try:
            kind = DomainKind(parts[0].lower())
        except ValueError as e:
            raise GrError(f"unknown compute-domain kind {parts[0]!r}; "
                          f"known: {[k.value for k in DomainKind]}") from e
        backend = parts[1] if len(parts) > 1 and parts[1] else \
            ("xla" if kind is DomainKind.GPU else "")
        idx = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        return cls(kind=kind, backend=backend, device_index=idx)

    def __str__(self) -> str:
        return f"{self.kind.value}:{self.backend}:{self.device_index}"


DEFAULT_DEVICE = ComputeDomain()
HOST = ComputeDomain(kind=DomainKind.HOST, backend="", access=Access.HOST_ONLY)
