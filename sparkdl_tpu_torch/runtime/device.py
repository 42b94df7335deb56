"""Device selection, float32 precision, and the CUDA streams and the
launch thread of the port's entry points."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]

_tf32_lock = threading.Lock()
_tf32_holders = 0
_tf32_saved: Optional[Tuple[bool, bool]] = None


@contextmanager
def exact_float32() -> Iterator[None]:
    """Run float32 convolutions and matmuls in float32, not TF32.

    PyTorch lets cuDNN convolutions round float32 inputs to TF32 by default
    (``torch.backends.cudnn.allow_tf32``); a model that promises float32
    results turns both TF32 switches off around its own forward. The
    switches are process-wide and two forwards may overlap on two threads
    (a caller's thread and the serving launcher), so the window is
    reference-counted under a lock: the first holder saves the caller's
    switches and turns them off, the last one to leave puts them back.
    Another thread's float32 work inside the window also runs without TF32.
    """
    global _tf32_holders, _tf32_saved
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _tf32_lock:
        if _tf32_holders == 0:
            _tf32_saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _tf32_holders += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_holders -= 1
            if _tf32_holders == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _tf32_saved
                _tf32_saved = None


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    With the default and no CUDA device this raises instead of falling
    back to the CPU; a caller that wants the CPU says ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


_streams_lock = threading.Lock()
_compute_streams: Dict[int, "torch.cuda.Stream"] = {}
_copy_streams: Dict[int, "torch.cuda.Stream"] = {}
_launchers: Dict[int, "Launcher"] = {}


def compute_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one stream that serving and feeder compute runs on, per CUDA
    device. Every model's batches are issued on it, so the flash kernel
    (which launches on the current stream) and cuBLAS/cuDNN share one
    order; the only cross-stream wait is on a staged input's copy."""
    with _streams_lock:
        idx = _index(device)
        s = _compute_streams.get(idx)
        if s is None:
            s = _compute_streams[idx] = torch.cuda.Stream(idx)
        return s


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The host-to-device copy stream of ``device``, created once: one
    PCIe link, one stream of copies riding under the compute stream."""
    with _streams_lock:
        idx = _index(device)
        s = _copy_streams.get(idx)
        if s is None:
            s = _copy_streams[idx] = torch.cuda.Stream(idx)
        return s


class Launcher:
    """One thread that runs the callables handed to it, in turn.

    Eager PyTorch issues a forward's kernels from the calling thread's
    host code. Several threads issuing forwards at once contend for the
    interpreter lock and each gets a cuBLAS handle and workspace of its
    own, so the shared feeder's owner threads (one per stream) hand their
    forwards to the device's launcher instead of running them themselves.
    :meth:`run` blocks until the callable has returned on the launcher
    thread (its kernels are queued, not finished) and returns its result
    or raises its exception. The thread is a daemon that waits on its
    queue for the life of the process. ``first``: a callable that runs as
    the thread's first job, before anything :meth:`run` hands it."""

    def __init__(self, name: str, first: Optional[Callable] = None):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        if first is not None:
            self._q.put((Future(), first, ()))
        self.thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self.thread.start()

    def run(self, fn: Callable, *args):
        if threading.current_thread() is self.thread:
            return fn(*args)
        done = Future()
        self._q.put((done, fn, args))
        return done.result()

    def _loop(self) -> None:
        while True:
            self._run_one(*self._q.get())

    @staticmethod
    def _run_one(done: Future, fn: Callable, args) -> None:
        # a call of its own, so that nothing of the job (its callable, its
        # arguments, its result) stays referenced while the queue is empty
        try:
            done.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 - the caller re-raises
            done.set_exception(e)


def launcher(device: torch.device) -> Launcher:
    """The launcher of CUDA ``device``, started on first use. Its first job
    creates its cuBLAS workspaces and notes them in the memory ledger
    (:func:`_note_workspaces`), before any GEMM it is handed."""
    with _streams_lock:
        idx = _index(device)
        la = _launchers.get(idx)
        if la is None:
            la = _launchers[idx] = Launcher(
                f"sparkdl-launch-cuda{idx}", first=lambda: _note_workspaces(idx)
            )
        return la


def _warm_blas(device: torch.device) -> None:
    """A plain product, one with a bias (the cuBLASLt epilogue) and a
    batched one, in float32 and bfloat16, on ``device``'s compute stream."""
    with torch.cuda.stream(compute_stream(device)):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones(64, 64, device=device, dtype=dtype)
            bias = torch.ones(64, device=device, dtype=dtype)
            torch.mm(a, a)
            torch.addmm(bias, a, a)
            torch.bmm(a[None], a[None])


#: devices whose launch thread's workspaces the memory ledger holds
_workspace_noted: set = set()


def _note_workspaces(idx: int) -> None:
    """On the launch thread: :func:`_warm_blas`, measured when the ledger
    does not hold this device's workspaces yet (the launcher's first job,
    and the first warm-up after :func:`clear_workspaces`): the bytes
    ``memory_allocated`` gained across it are the workspaces it created,
    attributed as the memory ledger's ``workspace`` class. What another
    thread allocates during those six products would be counted with
    them."""
    from sparkdl_tpu_torch.obs import memory

    dev = torch.device("cuda", idx)
    with _streams_lock:
        measure = idx not in _workspace_noted
        _workspace_noted.add(idx)
    before = torch.cuda.memory_allocated(dev) if measure else 0
    _warm_blas(dev)
    if measure:
        nbytes = torch.cuda.memory_allocated(dev) - before
        if nbytes > 0:
            memory.note_workspace(nbytes)


def warm_launcher(device: torch.device) -> None:
    """Make sure the launch thread's cuBLAS and cuBLASLt workspaces exist
    on ``device``'s compute stream.

    A thread's first GEMM on a stream allocates them, and they stay for
    the life of the process unless cleared (:func:`clear_workspaces`). A
    reading of ``torch.cuda.memory_allocated`` taken right after this call
    (the memory ledger's baseline before a model's load) already holds
    them, so the model's first forward does not add them to its residue at
    evict. Six products of 64 x 64 once they exist."""
    idx = _index(device)
    launcher(device).run(_note_workspaces, idx)


def clear_workspaces() -> None:
    """Free every thread's cuBLAS workspaces
    (``torch._C._cuda_clearCublasWorkspaces``) and return the launch
    threads' from the memory ledger; the next :func:`warm_launcher`
    measures them anew."""
    from sparkdl_tpu_torch.obs import memory

    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    with _streams_lock:
        _workspace_noted.clear()
    memory.release_workspace()
