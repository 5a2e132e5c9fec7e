"""The ('data', 'model') mesh of ranks over torch.distributed
(counterpart of the JAX parallel/mesh.py).

JAX runs one process over many devices and lets GSPMD partition
global-batch programs; the port runs one process per device, PyTorch's
idiom, and keeps JAX's defining property by hand: a mesh run computes
the single-device run's numbers.

  * rank r sits at mesh position (data r // n_model, model r % n_model),
    the order of JAX's ``devices.reshape(n_data, n_model)``;
  * a batch is split over 'data' in contiguous rows when the data axis
    divides it, and replicated (every data rank runs it whole, no
    padding, no masking) when it does not (`place_batch`);
  * the capsule route weights may be sharded over 'model' on their node
    axis (`routing_param_spec`), everything else is replicated;
  * the steps' collectives (gradient all-reduce, global-batch BN, the
    node-sharded routing's sums) are in `collectives`.

`launch` starts the ranks: ``--mesh data=N[,model=M]`` spawns N*M local
ranks, or N*M/P per process under ``--coordinator/--num_processes/
--process_id``; rank r of a process runs on ``cuda:r`` over NCCL, or on
the CPU over gloo.  Nothing switches backend or device on its own:
callers that must choose (two ranks on one card, which NCCL refuses)
pass ``backend=``.
"""

import dataclasses
import importlib
import os
import socket
import sys
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: the axis sizes, its rank, its device
    and its two process groups (``data_group``: the ranks of its model
    column, over which batches are split and gradients summed;
    ``model_group``: the ranks of its data row, over which the route
    weights' nodes are split)."""

    n_data: int
    n_model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    data_group: object = None
    model_group: object = None

    @property
    def data_rank(self):
        return self.rank // self.n_model

    @property
    def model_rank(self):
        return self.rank % self.n_model

    @property
    def is_primary(self):
        return self.rank == 0


def initialize_distributed(coordinator_address, world_size, rank, backend):
    """Join the default process group over a ``tcp://`` rendezvous at
    ``coordinator_address`` ("host:port") as ``rank`` of ``world_size``
    ranks, over ``backend`` ("nccl" or "gloo"; JAX
    `initialize_distributed`, one call per rank here where JAX makes one
    per process)."""
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(world_size), rank=int(rank))


def is_primary() -> bool:
    """True on the artifact-writing rank (rank 0), and single-process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_replicated(x, mesh: Optional[Mesh]):
    """All-gather the data ranks' equal row blocks of ``x`` into the
    global rows, in row order (rank 0's first), on every rank.  Returns
    ``x`` itself without a mesh."""
    if mesh is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts)


def gather_batches(parts, n_globals, mesh: Optional[Mesh]):
    """Per-batch outputs ``parts`` (this rank's rows of global batches of
    ``n_globals`` rows) -> every batch's rows in global row order, on
    every rank: the split batches' rows from every data rank in one
    all-gather, each replicated batch as this rank ran it."""
    if mesh is None:
        return torch.cat(parts)
    split = [n % mesh.n_data == 0 for n in n_globals]
    own = [t for t, s in zip(parts, split) if s]
    ranks = []
    if own:
        ranks = [p.split([t.shape[0] for t in own]) for p in
                 gather_replicated(torch.cat(own), mesh).chunk(mesh.n_data)]
    out, k = [], 0
    for t, s in zip(parts, split):
        if s:
            out += [r[k] for r in ranks]
            k += 1
        else:
            out.append(t)
    return torch.cat(out)


def all_reduce_rows(x, mesh: Mesh):
    """The sum of ``x`` over the data group (the epoch's per-batch loss
    and avg_iou sums: one collective an epoch)."""
    x = x.clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x


def gather_nodes(x, mesh: Mesh):
    """The whole route weights (or moments) from the model ranks' node
    shards of ``x`` (1, N / n_model, ...), concatenated on the node axis
    in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_model)]
    dist.all_gather(parts, x, group=mesh.model_group)
    return torch.cat(parts, dim=1)


def process_batch_slice(n_global: int, process_index=None,
                        process_count=None):
    """Row range [lo, hi) of the global batch owned by this rank: an
    equal contiguous split, the first ``n_global % count`` ranks one row
    longer (JAX `process_batch_slice`)."""
    pi = (dist.get_rank() if dist.is_initialized() else 0) \
        if process_index is None else process_index
    pc = (dist.get_world_size() if dist.is_initialized() else 1) \
        if process_count is None else process_count
    per, rem = divmod(n_global, pc)
    lo = pi * per + min(pi, rem)
    hi = lo + per + (1 if pi < rem else 0)
    return lo, hi


def batch_rows(n_global: int, mesh: Mesh):
    """(lo, hi): this rank's rows of a global batch of ``n_global``, all
    of them when the data axis does not divide it (replicated)."""
    if n_global % mesh.n_data:
        return 0, n_global
    per = n_global // mesh.n_data
    return mesh.data_rank * per, (mesh.data_rank + 1) * per


def process_row_slices(n_global: int, mesh: Mesh):
    """The global-row slices this rank must load for a batch of
    ``n_global`` rows: its data block (the same rows on every rank of its
    data row), or every row when the data axis does not divide the batch
    (JAX `process_row_slices`; one rank here holds one device)."""
    return [batch_rows(n_global, mesh)]


def place_batch(batch, mesh: Mesh):
    """This rank's rows of each tensor of a global ``batch`` (a tuple), on
    its device: its data block when the data axis divides the batch, the
    whole batch otherwise (a ragged tail is replicated, as the JAX
    package's `place_batch` replicates it: the numbers stay the
    single-device ones, at the cost of duplicated tail compute)."""
    lo, hi = batch_rows(batch[0].shape[0], mesh)
    return tuple(a[lo:hi].to(mesh.device) for a in batch)


def parse_mesh_spec(spec, n_local: Optional[int] = None):
    """Parse the CLI --mesh spec into (n_data, n_model) or None.

    Grammar (JAX `parse_mesh_spec`):
      'off' | 'none' | '1'      -> None (single-device, reference behavior)
      'auto'                    -> all ``n_local`` devices on 'data' when
                                   >1, else None
      'data=N[,model=M]'        -> explicit axis sizes
    ``n_local`` defaults to the count of local cards.
    """
    if spec is None:
        return None
    spec = str(spec).strip().lower()
    if spec in ("off", "none", "1", ""):
        return None
    if n_local is None:
        n_local = torch.cuda.device_count()
    if spec == "auto":
        return (n_local, 1) if n_local > 1 else None
    n_data, n_model = None, 1
    for part in spec.split(","):
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key == "data":
            n_data = int(val)
        elif key == "model":
            n_model = int(val)
        else:
            raise ValueError(f"bad --mesh spec {spec!r} (part {part!r})")
    if n_data is None:
        raise ValueError(f"--mesh spec {spec!r} needs data=N")
    if n_data * n_model > n_local:
        raise ValueError(
            f"--mesh {spec!r} wants {n_data * n_model} devices, "
            f"only {n_local} available")
    if n_data == 1 and n_model == 1:
        return None
    return (n_data, n_model)


def mesh_shape(spec, device="cuda", num_processes=1):
    """The CLI's (n_data, n_model) or None for ``--mesh spec`` on
    ``device``: the devices are the local cards (times the processes
    under ``--coordinator``) for cuda, the cores for cpu, whose ranks
    are processes over gloo; 'auto' means every card when there are
    more than one, so it is off on the CPU."""
    if torch.device(device).type == "cpu":
        if str(spec).strip().lower() == "auto":
            return None
        n_local = os.cpu_count() or 1
    else:
        n_local = torch.cuda.device_count()
    return parse_mesh_spec(spec, n_local * int(num_processes))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """This rank's `Mesh` over the default process group (every rank
    calls it, in the same order: it creates the groups).  ``n_data``
    defaults to all ranks over ``n_model``.  ``device`` defaults to the
    current card under NCCL, the CPU otherwise."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh data={n_data} model={n_model} needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    rank = dist.get_rank()
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    return Mesh(n_data=n_data, n_model=n_model, rank=rank,
                device=torch.device(device),
                data_group=data_groups[rank % n_model],
                model_group=model_groups[rank // n_model])


def maybe_make_mesh(spec, device=None) -> Optional[Mesh]:
    """CLI spec -> this rank's Mesh, or None when single-device suffices;
    the devices counted are the group's ranks."""
    parsed = parse_mesh_spec(spec, dist.get_world_size()
                             if dist.is_initialized() else 1)
    if parsed is None:
        return None
    return make_mesh(*parsed, device=device)


def routing_param_spec(name):
    """The sharding of a parameter named ``name`` over the (N, K, in_c,
    out_c) view of its value (JAX `routing_param_spec`): the capsule
    route weights on their node axis N, the routing contraction (1296
    nodes for CapsuleNet), over 'model', so the node sum becomes partial
    sums that one all-reduce completes; everything else replicated
    (an empty spec).  The capsule axis would be the other candidate, but
    43 is prime."""
    if name.endswith("route_weights"):
        return ("model", None, None, None)
    return ()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn, args, n_data, n_model=1, device="cuda", coordinator=None,
           num_processes=1, process_id=0):
    """Run ``fn(*args, mesh=<this rank's Mesh>)`` on every rank of an
    (n_data, n_model) mesh; returns when every local rank has finished.

    Without ``coordinator`` this process spawns all n_data * n_model
    ranks over a local rendezvous; with it ("host:port"), it is process
    ``process_id`` of ``num_processes`` and spawns its n_data * n_model /
    num_processes ranks, global ranks from process_id times that.  Local
    rank i runs on ``cuda:i`` under NCCL (``device`` cuda), or on the CPU
    under gloo.  Ranks are spawned
    (fresh interpreters, ``fn`` pickled by its import path), or run in
    this process when it holds one rank.  Each rank ends with a barrier,
    so none leaves before rank 0's last write."""
    world = int(n_data) * int(n_model)
    if world % int(num_processes):
        raise ValueError(f"--mesh data={n_data},model={n_model}: "
                         f"{world} ranks do not split over "
                         f"{num_processes} processes")
    per = world // int(num_processes)
    if coordinator is None:
        if int(num_processes) != 1:
            raise ValueError("--num_processes needs --coordinator")
        coordinator = f"127.0.0.1:{_free_port()}"
    dev_type = torch.device(device).type
    backend = "nccl" if dev_type == "cuda" else "gloo"
    ctx = (_import_path(fn), tuple(args), world, int(process_id) * per,
           per, coordinator, backend, dev_type, int(n_data), int(n_model))
    if per == 1:
        _rank_entry(0, *ctx)
    else:
        import torch.multiprocessing as mp

        mp.spawn(_rank_entry, args=ctx, nprocs=per, join=True)


def _import_path(fn):
    """(module, qualified name) that a spawned rank imports ``fn`` by:
    the real name of a ``python -m`` or script ``__main__``, whose
    functions do not unpickle in a fresh interpreter."""
    mod = fn.__module__
    if mod == "__main__":
        main = sys.modules["__main__"]
        spec = getattr(main, "__spec__", None)
        mod = (spec.name if spec is not None else
               os.path.splitext(os.path.basename(main.__file__))[0])
    return mod, fn.__qualname__


def _rank_entry(local_rank, fn, args, world, rank0, n_local, coordinator,
                backend, dev_type, n_data, n_model):
    fn = getattr(importlib.import_module(fn[0]), fn[1])
    device = torch.device("cpu")
    if dev_type == "cpu" and n_local > 1 and "OMP_NUM_THREADS" not in \
            os.environ:
        # CPU ranks share the cores: each its share of the threads
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_local))
    if dev_type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    initialize_distributed(coordinator, world, rank0 + local_rank, backend)
    try:
        mesh = maybe_make_mesh(f"data={n_data},model={n_model}", device)
        fn(*args, mesh=mesh)
        dist.barrier()
    finally:
        dist.destroy_process_group()
