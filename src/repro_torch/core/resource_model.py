"""Paraver resource model: SYSTEM > NODE > CPU.

The torch port runs in one process on one host: one NODE whose CPUs are
the visible CUDA devices (one on a machine without CUDA).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResourceModel:
    num_nodes: int
    cpus_per_node: list[int]

    @property
    def total_cpus(self) -> int:
        return sum(self.cpus_per_node)


def from_torch_devices() -> ResourceModel:
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ResourceModel(num_nodes=1, cpus_per_node=[max(count, 1)])


def node_of_task(rm: ResourceModel, num_tasks: int) -> list[int]:
    """Round-robin tasks over nodes (contiguous blocks, MPI-style)."""
    per = max(num_tasks // rm.num_nodes, 1)
    return [min(t // per, rm.num_nodes - 1) for t in range(num_tasks)]
