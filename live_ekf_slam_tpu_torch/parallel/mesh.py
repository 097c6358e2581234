"""World-batch data parallelism over a 1-D mesh of devices.

Counterpart of ``live_ekf_slam_tpu/parallel/mesh.py``. The system's parallel
axis is Monte-Carlo *worlds*: independent sim + filter instances, batched on
one device and split over devices along the leading world axis. Per-world
state is small, so nothing else is split; the only cross-device step is the
metric reduction (``mean_over_worlds``).

A ``Mesh`` is an ordered tuple of ``torch.device``, the counterpart of a 1-D
``jax.sharding.Mesh``. ``make_mesh`` takes the first n CUDA devices. A mesh
whose list repeats a device is a *virtual* mesh, the counterpart of XLA's
forced host device count: every shard on that device runs on a CUDA stream
of its own, so shards on one card may overlap; on the CPU they run one after
another. A real mesh spans several cards: each device's shards run in a
thread of their own under ``torch.cuda.device``, so that the host-bound
per-tick step drives every card at once.

A placed tree is a ``Shards``: one tree per shard, shard d on
``mesh.devices[d]``, its tensors produced on shard d's stream. Trees are
those of ``utils/checkpoint.tree_map`` (tensors, dataclasses such as
``eval/runner.RunCarry``, tuples, lists, dicts). ``shard_batch`` places a
tree, ``gather`` puts it back on one device, ``map_shards`` and
``sharded_step`` run a function on every shard, ``mean_over_worlds`` reduces.
Streams: a shard's work waits for what the device's current stream queued
before it; tensors read on another stream than the one they were made on
are marked with ``record_stream``, so the caching allocator does not hand
their memory out while a kernel still reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from live_ekf_slam_tpu_torch.utils.checkpoint import leaves, tree_map

WORLD_AXIS = "worlds"
# shard d of a rollout draws its Philox stream from seed + d * SEED_STRIDE
# (mod 2^32; JAX: seed + axis_index * int32(1000003), which wraps in int32
# to the same bits)
SEED_STRIDE = 1000003
MASK32 = 0xFFFFFFFF


def shard_seed(seed: int, d: int) -> int:
    """The Philox seed of shard ``d`` of a sharded rollout."""
    return (int(seed) + d * SEED_STRIDE) & MASK32


class Mesh:
    """A 1-D world mesh: ``devices``, in shard order. A device may appear
    more than once (a virtual mesh); every device is of one type."""

    axis_names = (WORLD_AXIS,)

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type, not {devs}")
        # "cuda" and "cuda:0" are one device
        self.devices = tuple(torch.device("cuda", d.index or 0)
                             if d.type == "cuda" else d for d in devs)
        self._streams = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {WORLD_AXIS: self.size}

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def distinct_devices(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))

    def groups(self) -> list:
        """The shards of each distinct device, in order: what one thread
        of ``map_shards`` runs."""
        return [[d for d, dev in enumerate(self.devices) if dev == g]
                for g in self.distinct_devices]

    @property
    def virtual(self) -> bool:
        """Whether a device holds more than one shard."""
        return len(self.distinct_devices) < self.size

    def stream(self, d: int):
        """Shard ``d``'s CUDA stream (made at first use), None on the CPU."""
        if self.device_type != "cuda":
            return None
        if self._streams is None:
            self._streams = [torch.cuda.Stream(dev) for dev in self.devices]
        return self._streams[d]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, device_type: str = "cuda") -> Mesh:
    """A mesh of the first ``n_devices`` devices (all of them by default).

    ``device_type="cuda"`` raises without CUDA, and with fewer than n cards;
    a virtual mesh is ``virtual_mesh(n)``. ``device_type="cpu"`` gives n
    shards on the CPU (one by default), a virtual mesh like JAX's forced
    host device count.
    """
    if device_type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"make_mesh: device_type cuda or cpu, not {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda.is_available() is false "
                           "(device_type='cpu' gives a CPU mesh)")
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(
            f"make_mesh({n_devices}) requested but only {count} CUDA "
            f"device(s) are available. For a virtual mesh of {n} shards on "
            f"one card use virtual_mesh({n}) (streams on cuda:0).")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def virtual_mesh(n: int, device="cuda") -> Mesh:
    """``n`` shards on one device, each on a stream of its own on a card."""
    return Mesh([torch.device(device)] * n)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a tree lies on a mesh (the counterpart of ``NamedSharding``):
    split along ``axis`` into equal contiguous slices, shard d the d-th, or,
    with ``axis`` None, a whole copy on every shard."""

    mesh: Mesh
    axis: int | None = 0


def world_sharding(mesh: Mesh, axis: int = 0) -> Placement:
    """Shard the world axis, ``axis`` (the leading one by default)."""
    return Placement(mesh, axis)


def replicated(mesh: Mesh) -> Placement:
    """A whole copy on every shard (the closed loop's occupancy grid)."""
    return Placement(mesh, None)


class Shards:
    """A tree placed on a mesh: ``parts[d]`` is shard d's tree, on
    ``mesh.devices[d]``."""

    def __init__(self, parts, placement: Placement):
        self.parts = tuple(parts)
        self.placement = placement
        if len(self.parts) != placement.mesh.size:
            raise ValueError(f"{len(self.parts)} parts for a mesh of "
                             f"{placement.mesh.size}")

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, d: int):
        return self.parts[d]

    def map(self, fn) -> "Shards":
        """``fn`` on every leaf of every shard, on that shard's stream: the
        result keeps this placement (a slice along another axis than the
        world axis, for example)."""
        return map_shards(self.mesh, lambda d: tree_map(self.parts[d], fn),
                          self.placement.axis)

    def join(self) -> "Shards":
        """Make every tensor safe to read on its device's current stream
        (which waits for the shard streams). Returns self."""
        mesh = self.mesh
        for d, part in enumerate(self.parts):
            s = mesh.stream(d)
            if s is None:
                continue
            cur = torch.cuda.current_stream(mesh.devices[d])
            cur.wait_stream(s)
            _record(part, cur)
        return self


def _record(tree, stream) -> None:
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return  # a Python value handed to every shard
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)


@contextlib.contextmanager
def on_shard(mesh: Mesh, d: int):
    """Shard ``d``'s device and stream; its stream first waits for what the
    device's current stream has queued."""
    s = mesh.stream(d)
    if s is None:
        yield
        return
    dev = mesh.devices[d]
    with torch.cuda.device(dev):
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            yield


def map_shards(mesh: Mesh, fn, axis: int | None = 0) -> Shards:
    """``Shards`` of ``fn(d)`` for every shard d, each run under
    ``on_shard``: the shards of one device in order, each device's in a
    thread of its own when the mesh spans several devices (the JAX
    package's ``shard_map`` with ``axis_index``). ``axis``: the world axis
    of the results (None: replicated). A shard's failure raises here."""
    def run(ds):
        out = []
        for d in ds:
            with on_shard(mesh, d):
                out.append((d, fn(d)))
        return out

    groups = mesh.groups()
    mesh.stream(0)  # the streams, made here before any thread reads them
    if len(groups) == 1:
        done = run(groups[0])
    else:
        with ThreadPoolExecutor(len(groups)) as pool:
            futures = [pool.submit(run, g) for g in groups]
            done = [r for f in futures for r in f.result()]
    parts = [None] * mesh.size
    for d, r in done:
        parts[d] = r
    return Shards(parts, Placement(mesh, axis))


def _split(x: torch.Tensor, axis: int, mesh: Mesh, d: int) -> torch.Tensor:
    n = mesh.size
    if x.dim() <= axis:
        raise ValueError(f"a leaf of shape {tuple(x.shape)} has no axis {axis}")
    b = x.shape[axis]
    if b % n:
        raise ValueError(f"batch {b} not divisible by mesh size {n}")
    return x.narrow(axis, d * (b // n), b // n)


def shard_batch(tree, mesh_or_placement) -> Shards:
    """Place a batched tree on a mesh: with a ``Mesh``, or a ``Placement``
    with an axis, every leaf's world axis is split into n equal contiguous
    slices, shard d's copied to ``mesh.devices[d]`` (``ValueError`` unless n
    divides it); with ``replicated(mesh)`` every shard gets a copy. A slice
    along another axis than the leading one is made contiguous."""
    placement = (mesh_or_placement if isinstance(mesh_or_placement, Placement)
                 else world_sharding(mesh_or_placement))
    mesh, axis = placement.mesh, placement.axis
    if axis is not None:  # check every leaf before copying any
        for leaf in leaves(tree):
            _split(torch.as_tensor(leaf), axis, mesh, 0)

    def place(d):
        dev = mesh.devices[d]

        def one(x):
            x = torch.as_tensor(x)
            if axis is not None:
                x = _split(x, axis, mesh, d)
            # a copy on shard d's stream (its own storage, even on the
            # device the tree came from), contiguous
            return x.to(dev, copy=True, memory_format=torch.contiguous_format)
        return tree_map(tree, one)

    out = map_shards(mesh, place, axis)
    for d in range(mesh.size):  # the sources were read on the shard streams
        s = mesh.stream(d)
        for leaf in leaves(tree):
            if (s is not None and isinstance(leaf, torch.Tensor)
                    and leaf.device == mesh.devices[d]):
                leaf.record_stream(s)
    return out


def gather(shards: Shards, device=None):
    """The tree of ``shards`` on one device (the mesh's first by default):
    every leaf concatenated along the world axis, or, for a replicated
    tree, shard 0's copy. Reads after the shards' streams have finished."""
    mesh, axis = shards.mesh, shards.placement.axis
    device = torch.device(device) if device is not None else mesh.devices[0]
    shards.join()
    if axis is None:
        return tree_map(shards.parts[0], lambda x: x.to(device))
    cols = iter(list(zip(*(leaves(p) for p in shards.parts))))
    return tree_map(shards.parts[0], lambda _: torch.cat(
        [x.to(device) for x in next(cols)], dim=axis))


def mean_over_worlds(x, mesh: Mesh | None = None) -> torch.Tensor:
    """The mean over worlds (axis 0) of a sharded tensor: each shard's sum
    on its own device, the sums reduced on the mesh's first device, divided
    by the world count. A tensor that is not sharded: ``torch.mean(x, 0)``."""
    if not isinstance(x, Shards):
        return torch.mean(x, dim=0)
    if mesh is not None and mesh != x.mesh:
        raise ValueError(f"the tensor lies on {x.mesh}, not {mesh}")
    if x.placement.axis != 0:
        raise ValueError("mean_over_worlds reduces a tensor sharded on axis 0")
    sums = map_shards(x.mesh, lambda d: x.parts[d].sum(dim=0))
    total = sum(p.shape[0] for p in x.parts)
    return torch.stack(
        [s.to(x.mesh.devices[0]) for s in sums.join().parts]).sum(dim=0) / total


def _place_arg(a, mesh: Mesh):
    """A step argument as Shards: Shards as they are (on this mesh), Python
    scalars and None to every shard, a tree sharded on its leading axis."""
    if isinstance(a, Shards):
        if a.mesh != mesh:
            raise ValueError(f"an argument lies on {a.mesh}, not {mesh}")
        return a
    if a is None or isinstance(a, (bool, int, float, str)):
        return Shards([a] * mesh.size, replicated(mesh))
    return shard_batch(a, mesh)


def sharded_step(step_fn, mesh: Mesh):
    """``step_fn`` on a world mesh: the returned function takes the step's
    arguments (``Shards`` as placed, Python scalars to every shard, any other
    tree sharded on its leading axis), runs ``step_fn`` on every shard on
    that shard's device and stream, and returns the step's result as
    ``Shards`` on the leading axis: a tuple result as a tuple of ``Shards``
    ((carry, out), as the JAX package's jitted step returns them sharded).
    ``step_fn`` sees one shard's batch; it must make no decision for the
    whole batch (each shard decides for its own worlds)."""
    def run(*args):
        placed = [_place_arg(a, mesh) for a in args]

        def one(d):
            shard_args = [p.parts[d] for p in placed]
            out = step_fn(*shard_args)
            s = mesh.stream(d)
            if s is not None:  # inputs made on other streams: keep them
                for a in shard_args:
                    _record(a, s)
            return out

        res = map_shards(mesh, one)
        first = res.parts[0]
        if isinstance(first, tuple) and not hasattr(first, "_fields"):
            return tuple(Shards([r[i] for r in res.parts], res.placement)
                         for i in range(len(first)))
        return res

    return run


def sharded_rollout(rollout, mesh: Mesh, landmarks, cmds, seed: int,
                    noise=None, **kw) -> dict:
    """``rollout(landmarks, cmds, seed, noise=..., **kw)`` on a world mesh,
    the body of the sharded fused wrappers: landmarks (B, N, 2) and cmds
    (B, T, 2) split on axis 0, noise (T, 2N+8, B) on axis 2 (one copy of
    the whole, so that each shard's slice is contiguous), shard d run on its
    slice at ``shard_seed(seed, d)``; the results concatenated over worlds
    on the mesh's first device."""
    b = landmarks.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch {b} not divisible by mesh size {mesh.size}")
    inputs = shard_batch((landmarks, cmds), mesh)
    nz = (None if noise is None
          else shard_batch(noise, world_sharding(mesh, 2)))
    out = map_shards(mesh, lambda d: rollout(
        *inputs[d], shard_seed(seed, d),
        noise=None if nz is None else nz[d], **kw))
    return gather(out)
