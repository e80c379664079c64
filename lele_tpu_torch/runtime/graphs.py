"""One captured CUDA graph a bucket: the port's counterpart of what `jax.jit`
gives each entry point of the JAX package (one compiled program a bucket,
with `donate_argnums` for streaming state).

A `Program` is one function captured once, at first use, on static input
buffers of fixed shapes, as JAX compiles at a function's first call:

- **First call.** The inputs are copied into the program's static buffers;
  the function runs once eagerly on them, on a side stream (the warm-up:
  cuFFT plans, cuBLAS and cuDNN handles, the kernels' first `ctypes` load
  and `cudaFuncSetAttribute` all happen there, before any capture), and
  that run is the call's answer. Then the function is captured on the same
  buffers into a `torch.cuda.CUDAGraph` whose memory comes from the pool
  of the program's owner (`torch.cuda.graph_pool_handle()`).
- **Every later call** copies its inputs into the static buffers, replays
  the graph once and returns fresh tensors that belong to the caller, as
  JAX's outputs do: no later call of the program changes them.
- **Donation.** `donate={i: j}` makes output j the new value of input i (a
  tensor or a tree of them, of the same structure): inside the graph it is
  written back into input i's static buffers, and the call returns a copy
  of them that the caller owns. Passed back unchanged into the next call
  of the same program, that copy is not copied in again (the buffers
  already hold its value), so one stream's state recirculates with one
  copy a call; a copy from an earlier call, another session's state or a
  copy changed in place is copied in, so sessions interleaved through one
  program do not see each other's state.
- **Repeats.** `repeat=n` runs the function n times in one call, each run
  from the donated state the run before left in the static buffers: after
  the first call, n replays back to back with no host work between them
  (a decode step replayed once a token, runtime/decode.py).
- **Launch counts.** A replay runs no kernel wrapper, so the capture
  records what the function's launches and routes added to the counters
  (`kernels.launch_counts()`, `nn_ops.RNN_ROUTES`,
  `attention_ops.ATTENTION_ROUTES`), sets the counters back, and each
  replay adds that record once. The warm-up's launches are real and count:
  every call of a program counts what the uncaptured function would.
- **No collection inside a capture.** Python's cyclic collector is held
  off while a graph is captured (`collector_paused`): a collection there
  may free a dropped program's graph, and destroying a graph while a
  stream captures is not permitted and invalidates the capture (its next
  launch fails; a cuBLAS product's as CUBLAS_STATUS_EXECUTION_FAILED).
- **Failure raises.** A capture that fails (something inside reads the
  host: `.item()`, a host-made tensor, a synchronisation) raises
  `CaptureError` naming the program and the step (the innermost frame of
  the port, and the tape's step where a tape ran). Nothing falls back to
  the eager path.

A call made while another capture is running (a program called from inside
an outer program, or inside a CUDA graph a measurement captures) runs the
function directly into that capture, on inputs already on the card. On the
CPU nothing is captured: `Programs.run` calls the function.

**Threads.** A program's static buffers, its capture and the counters' record
of that capture belong to the process, not to a thread: two threads calling
one program could copy in, copy in, replay, replay and each read the other's
answer, and a capture (in CUDA's global mode) fails if another thread does
card work meanwhile. So one thread at a time drives the card: a program's
call on a card (and `Programs.run`'s choice of program) holds `CARD_LOCK`,
a reentrant lock of the process, and the serving engines (serving.py) hold
it around all of a request's card work, its eager steps and read-backs
included. `config.precision_scope` holds it too, on the CPU as well: it
sets torch's process-wide TF32 flags for the length of a walk.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable, Hashable

import numpy as np
import torch

_TORCH = str(Path(torch.__file__).resolve().parent)


# one thread at a time drives the card's programs (module docstring, "Threads")
CARD_LOCK = threading.RLock()


class CaptureError(RuntimeError):
    """A function could not be captured in a CUDA graph."""


# -- trees of tensors -----------------------------------------------------------


def flatten(tree) -> tuple[list, Any]:
    """A tree of tuples, lists and dicts (keys in sorted order) → (its
    leaves, its structure). Leaves are tensors or other values; the
    structure of a tensor leaf records its shape and dtype, so two trees
    with the same structure are interchangeable as program inputs."""
    leaves: list = []

    def walk(t):
        if isinstance(t, (tuple, list)):
            return (type(t), tuple(walk(v) for v in t))
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, tuple(keys), tuple(walk(t[k]) for k in keys))
        leaves.append(t)
        if isinstance(t, (torch.Tensor, np.ndarray)):
            return ("leaf", tuple(t.shape), str(t.dtype).replace("torch.", ""))
        return ("leaf", None, None)

    return leaves, walk(tree)


def unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def build(s):
        if s[0] == "leaf":
            return next(it)
        if s[0] is dict:
            return {k: build(v) for k, v in zip(s[1], s[2])}
        return s[0](build(v) for v in s[1])

    return build(spec)


# -- launch and route counters ---------------------------------------------------


def _snapshot() -> list[dict]:
    """The launch counts and the RNN and Attention route counts."""
    from ..kernels import launch_counts
    from ..ops.attention_ops import ATTENTION_ROUTES
    from ..ops.nn_ops import RNN_ROUTES

    return [launch_counts(), dict(RNN_ROUTES), dict(ATTENTION_ROUTES)]


def _restore(snap: list[dict], add: bool = False) -> None:
    """Set the counters to `snap`, or add `snap` to them."""
    from ..kernels import add_launch_counts, set_launch_counts
    from ..ops.attention_ops import ATTENTION_ROUTES
    from ..ops.nn_ops import RNN_ROUTES

    (add_launch_counts if add else set_launch_counts)(snap[0])
    for routes, s in zip((RNN_ROUTES, ATTENTION_ROUTES), snap[1:]):
        for k, n in s.items():
            routes[k] = routes[k] + n if add else n


def _where(err: BaseException) -> str:
    """The innermost frame of err's traceback outside torch and this file,
    and the notes (a tape names its step in one)."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(_TORCH) and f.filename != __file__]
    where = (f"{Path(frames[-1].filename).name}:{frames[-1].lineno} in {frames[-1].name}"
             if frames else "an unknown step")
    notes = [n.strip() for n in getattr(err, "__notes__", ())]
    return where + "".join(f"; {n}" for n in notes)


# -- the program -------------------------------------------------------------------


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic collector off for the block, as it was after it. Every
    capture runs inside one (module docstring): garbage made before or during
    the capture is collected after it."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()



def _as_tensor(v):
    """A numpy leaf as a CPU tensor over its memory, in its own layout (numpy
    copies only an array with a negative stride, which torch cannot view)."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v) if min(v.strides, default=0) < 0
                                else v)
    return v


def run_directly(fn: Callable, args, donate: dict[int, int], repeat: int = 1):
    """fn(*args) with nothing captured, `repeat` times, each run's donated
    outputs the next run's inputs: what a program's call computes."""
    args = list(args)
    for k in range(repeat):
        out = fn(*args)
        if k + 1 < repeat:
            for i, j in donate.items():
                args[i] = out[j]
    return out


class Program:
    """`fn(*args)` captured once on static input buffers (module docstring).

    `args` fixes the inputs: a tree per argument, whose tensor (or numpy)
    leaves give the static buffers' shapes and dtypes on `device`; a later
    call's leaves are converted to those dtypes as they are copied in.
    `donate` maps an argument's index to the index of the output (in fn's
    returned tuple) that is its new value."""

    def __init__(self, fn: Callable, args: tuple, device: torch.device,
                 donate: dict[int, int] | None = None, pool=None, name: str = "program"):
        self.fn, self.device, self.pool, self.name = fn, torch.device(device), pool, name
        self.donate = dict(donate or {})
        self._specs, self.static = [], []
        with torch.inference_mode():
            for a in args:
                leaves, spec = flatten(a)
                bufs = []
                for v in leaves:
                    v = _as_tensor(v)
                    if not isinstance(v, torch.Tensor):
                        raise TypeError(f"{name}: a program's inputs are tensors, got "
                                        f"{type(v).__name__}")
                    bufs.append(torch.zeros(v.shape, dtype=v.dtype, device=self.device))
                self._specs.append(spec)
                self.static.append(bufs)
        self.graph: torch.cuda.CUDAGraph | None = None
        self._out = None
        self._delta: list[dict] = []
        # a donated static buffer's id → (the copy of it the last call
        # returned, that copy's version counter then)
        self._handed: dict[int, tuple] = {}

    def _args(self) -> list:
        return [unflatten(s, b) for s, b in zip(self._specs, self.static)]

    def _load(self, args) -> None:
        if len(args) != len(self._specs):
            raise TypeError(f"{self.name}: {len(args)} arguments, the program takes "
                            f"{len(self._specs)}")
        # emptied first: a load that fails halfway leaves no buffer trusted
        handed, self._handed = self._handed, {}
        for i, (a, spec, bufs) in enumerate(zip(args, self._specs, self.static)):
            leaves, got = flatten(a)
            if len(leaves) != len(bufs):
                raise ValueError(f"{self.name}: argument {i} has {len(leaves)} leaves, the "
                                 f"program was captured with {len(bufs)}")
            for s, v in zip(bufs, leaves):
                h = handed.get(id(s))
                if h is not None and h[0]() is v and v._version == h[1]:
                    continue  # the last call's donated copy, unchanged: s holds it
                v = _as_tensor(v)
                if tuple(v.shape) != tuple(s.shape):
                    raise ValueError(f"{self.name}: argument {i} has a leaf of shape "
                                     f"{tuple(v.shape)}; the program was captured at "
                                     f"{tuple(s.shape)}")
                s.copy_(v)

    def _donate_back(self, out):
        """Write each donated input's new value into its static buffers and
        put those buffers in its place in the outputs."""
        if not self.donate:
            return out
        out = list(out)
        for i, j in self.donate.items():
            leaves, spec = flatten(out[j])
            if spec != self._specs[i]:
                raise ValueError(f"{self.name}: output {j} does not match donated argument "
                                 f"{i}: {spec} against {self._specs[i]}")
            for s, v in zip(self.static[i], leaves):
                if v is not s:
                    s.copy_(v)
            out[j] = unflatten(self._specs[i], self.static[i])
        return tuple(out)

    def _hand(self, s: torch.Tensor) -> torch.Tensor:
        """A copy of donated static buffer s for the caller, made outside
        inference mode so that its version counter shows whether it was
        changed before it comes back (`_load`)."""
        with torch.inference_mode(False):
            c = s.clone()
        self._handed[id(s)] = (weakref.ref(c), c._version)
        return c

    def _fresh(self, out):
        """The graph's outputs as tensors of the caller's own."""
        donated = {id(s) for i in self.donate for s in self.static[i]}
        leaves, spec = flatten(out)
        return unflatten(spec, [v if not isinstance(v, torch.Tensor)
                                else self._hand(v) if id(v) in donated else v.clone()
                                for v in leaves])

    def __call__(self, *args, repeat: int = 1):
        """One call; `repeat` n runs the function n times back to back, each
        run from the donated state the run before left in the static buffers
        (after the first call, n replays with no host work between them),
        and returns the last run's outputs."""
        with CARD_LOCK, torch.inference_mode():
            if torch.cuda.is_current_stream_capturing():
                # inside another capture: that capture records the function
                return run_directly(self.fn, args, self.donate, repeat)
            self._load(args)
            replays = repeat
            if self.graph is None:
                result = self._capture()
                if repeat == 1:
                    return result
                replays = repeat - 1
            for _ in range(replays):
                self.graph.replay()
                _restore(self._delta, add=True)
            return self._fresh(self._out)

    def _capture(self):
        args = self._args()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self._donate_back(self.fn(*args))
        main.wait_stream(side)
        donated = {id(s) for i in self.donate for s in self.static[i]}
        inputs = {s.untyped_storage().data_ptr() for bufs in self.static for s in bufs}
        leaves, spec = flatten(result)
        for k, v in enumerate(leaves):
            if not isinstance(v, torch.Tensor):
                continue
            if id(v) in donated:
                leaves[k] = self._hand(v)
            elif v.untyped_storage().data_ptr() in inputs:
                leaves[k] = v.clone()  # an input passed through: the caller's own copy
            elif v.is_cuda:
                v.record_stream(main)  # made on the side stream, read on main
        result = unflatten(spec, leaves)
        before = _snapshot()
        # the graph is kept beside its executable, so that its kernel nodes
        # can be read (`raw_cuda_graph()`) and held against `_delta`
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        inner: list[BaseException] = []
        try:
            # captured on the warm-up's stream, whose cuBLAS workspace is set
            with collector_paused(), torch.cuda.graph(graph, pool=self.pool, stream=side):
                try:
                    out = self._donate_back(self.fn(*args))
                except Exception as e:
                    inner.append(e)
                    raise
        except Exception as e:
            _restore(before)
            err = inner[0] if inner else e
            raise CaptureError(f"capturing {self.name} in a CUDA graph failed at "
                               f"{_where(err)}: {type(err).__name__}: {err}") from err
        graph.instantiate()
        after = _snapshot()
        self._delta = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        _restore(before)
        self.graph, self._out = graph, out
        return result


class Programs:
    """The captured programs of one model, by key, in one memory pool.

    `run(key, make, *args, params=..., donate=...)` calls `make()(*args)`:
    on the CPU directly; on a card through the `Program` of `key`, built
    (and captured at its first call) from `make()` the first time. The
    programs hold the params they were made with: when `params` is another
    object than last time, every program is dropped and made again."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._progs: dict[Hashable, Program] = {}
        self._params = None
        self._pool = None

    def __len__(self) -> int:
        return len(self._progs)

    def run(self, key: Hashable, make: Callable[[], Callable], *args, params=None,
            donate: dict[int, int] | None = None, repeat: int = 1):
        if self.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            # the CPU, or inside another capture, which records the function
            with torch.inference_mode():
                return run_directly(make(), [_as_tensor(a) for a in args], donate or {},
                                    repeat)
        with CARD_LOCK:
            if params is not self._params:
                self._progs.clear()
                self._params = params
            prog = self._progs.get(key)
            if prog is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                prog = self._progs[key] = Program(make(), args, self.device, donate,
                                                  self._pool, name=f"program {key!r}")
            return prog(*args, repeat=repeat)
