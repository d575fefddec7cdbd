"""Ahead-of-time packing of the detector forward (port of
object_detection_tracking_tpu/runtime/aot.py).

The JAX package packs the forward as StableHLO (``jax.export``) beside
its params and ships XLA's compiled executables, so that another process
runs it with no model Python and no compile. The counterparts here:

  * ``export_serialized``: ``torch.export`` of the forward for the exact
    example shapes, serialized (``forward.pt2`` in a pack). The params are
    explicit inputs (``ParamsForward``), so the graph holds no weight; the
    hand-written kernels are single nodes (the custom ops
    ``odt::multilevel_roi_align`` and ``odt::greedy_keep``);
  * ``load_exported``: that graph loaded and run with no model class
    imported: ``ExportedProgram.graph_module`` on its lifted constants and
    the caller's inputs, in ``graph_signature`` order (``module()`` would
    generate attribute code such as ``self.rpn.class.weight``, and
    ``class`` is a Python keyword);
  * ``aot_compile``: the counterpart of XLA's compiled executable: on CUDA
    the callable warmed up on a side stream, captured into one
    ``torch.cuda.CUDAGraph`` with static input and output buffers, and
    replayed; a capture that fails raises;
  * ``enable_persistent_cache``: the counterpart of XLA's executable cache
    is native.py's hashed kernel libraries; a pack ships the libraries of
    the kernels its graph launches, and a library is loaded only where its
    hashed name (source and nvcc command) matches this tree's source;
  * ``device_put_tree_batched`` and ``load_packed`` as in JAX.

A pack is made for one device type, batch and image size, by one torch
version: ``load_packed`` raises on another torch, naming both.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import native
# the custom ops an exported graph calls: imported here so that a graph
# loads in a process that imports no model
from ..ops import nms as _nms  # noqa: F401  (odt::greedy_keep)
from ..ops import roi_align as _roi_align  # noqa: F401

# the kernel library (native.CUDA_SOURCES) each custom op launches
OP_KERNELS = {"odt.greedy_keep": "nms",
              "odt.multilevel_roi_align": "roi_align"}


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Where kernel libraries are found before a build: ``cache_dir`` (a
    pack's ``kernels/``) joins native.py's search directories, and a
    kernel's library is loaded from there only under its hashed name,
    that is, built from this tree's source by this nvcc command. Without
    ``cache_dir``, native.py's own build directory. Returns the directory
    (idempotent)."""
    if cache_dir is None:
        return native.BUILD_DIR
    cache_dir = os.path.abspath(cache_dir)
    if cache_dir not in native.library_dirs:
        native.library_dirs.insert(0, cache_dir)
    return cache_dir


class ParamsForward(torch.nn.Module):
    """``forward(params, images)``: ``model``'s forward with every weight
    taken from ``params``, a flat dict keyed by the native npz names
    (``names``: npz name -> the model's state name) in the port's layouts.
    float16 leaves are cast to float32 in the forward (a pack's
    ``--pack_params_dtype float16``). The model is held outside the module
    tree, so an export lifts none of its tensors: the weights stay inputs."""

    def __init__(self, model: torch.nn.Module, names: Dict[str, str]):
        super().__init__()
        self.__dict__["model"] = model
        self.names = dict(names)

    def forward(self, params: Dict[str, torch.Tensor], images: torch.Tensor):
        state = {}
        for name, attr in self.names.items():
            t = params[name]
            state[attr] = t.float() if t.dtype == torch.float16 else t
        return torch.func.functional_call(self.model, state, (images,))


def export_program(module: torch.nn.Module, *example_args: Any):
    """The ``torch.export`` ExportedProgram of ``module`` for the example
    args' exact shapes. ``module`` runs once eagerly first, so that
    per-shape caches (the anchors) hold real tensors, never the trace's."""
    with torch.inference_mode():
        module(*example_args)
    ep = torch.export.export(module, tuple(example_args), strict=False)
    ep.example_inputs = None    # else a saved file would hold them, params too
    return ep


def save_program(ep) -> bytes:
    """An ExportedProgram as the bytes of a ``.pt2`` file."""
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_serialized(module: torch.nn.Module, *example_args: Any) -> bytes:
    """``export_program`` of ``module`` (``ParamsForward`` for a pack),
    serialized: another process runs it with ``load_exported`` and no
    model Python."""
    return save_program(export_program(module, *example_args))


def _like(obj, spec):
    """``obj`` with every dict's keys in ``spec``'s order (torch's pytree
    flattens a dict in its insertion order)."""
    kids = (spec.children() if callable(getattr(spec, "children", None))
            else spec.children_specs)
    if spec.type is dict:
        return {k: _like(obj[k], c) for k, c in zip(spec.context, kids)}
    if spec.type in (tuple, list):
        return spec.type(_like(o, c) for o, c in zip(obj, kids))
    return obj


def exported_ops(ep) -> set:
    """The ``namespace.op`` names of the port's custom ops (``odt::``) that
    an ExportedProgram calls."""
    names = set()
    for node in ep.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op == "call_function" and schema is not None \
                and schema.name.startswith("odt::"):
            names.add(schema.name.replace("::", "."))
    return names


def load_exported(blob: bytes, device: Optional[torch.device] = None
                  ) -> Callable:
    """An ``export_serialized`` artifact as a callable of the exported
    function's arguments (shapes fixed). The graph runs eagerly, op by op,
    under inference mode; its lifted constants move to ``device`` where
    given. ``aot_compile`` captures it."""
    from torch.export.graph_signature import InputKind
    ep = torch.export.load(io.BytesIO(blob))
    gm = ep.graph_module
    lifted = []
    for spec in ep.graph_signature.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            lifted.append(None)
            continue
        if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER) \
                and spec.target in ep.state_dict:
            t = ep.state_dict[spec.target]
        elif spec.target in ep.constants:
            t = ep.constants[spec.target]
        else:
            raise ValueError(f"input {spec.arg.name} ({spec.kind}) has no "
                             f"value in the exported program")
        lifted.append(t.to(device) if device is not None else t)
    in_spec, out_spec = ep.call_spec.in_spec, ep.call_spec.out_spec

    def call(*args):
        user = iter(pytree.tree_leaves(_like((args, {}), in_spec)))
        flat = [next(user) if t is None else t for t in lifted]
        with torch.inference_mode():
            out = gm(*flat)
        return pytree.tree_unflatten(list(out), out_spec)

    call.exported_program = ep
    return call


def aot_compile(fn: Callable, *example_args: Any) -> Callable:
    """``fn`` for the example args' exact shapes and structure. On CUDA:
    ``fn`` run twice on a side stream (cuDNN and cuBLAS make
    their handles and workspaces, the kernels load), then captured into
    one CUDA graph over private static copies of the args; each call
    copies its args into them (a leaf that is the tensor copied last time,
    unmodified, is skipped: the params), replays the graph, and returns
    the outputs cloned out of the static buffers. A capture that fails
    raises; there is no eager fallback. Elsewhere (the CPU) ``fn`` as it
    is."""
    leaves = pytree.tree_leaves(example_args)
    device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
    if device.type != "cuda":
        return fn
    spec = pytree.tree_structure(example_args)
    static = [t.clone() for t in leaves]
    args = pytree.tree_unflatten(static, spec)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), torch.inference_mode():
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a CUDA call of another thread of the process (a
    # decoder, a profiler's sampler) does not invalidate the capture
    with torch.inference_mode(), torch.cuda.graph(
            graph, capture_error_mode="thread_local"):
        out = fn(*args)
    copied = [(t, t._version) for t in leaves]

    def replay(*call_args):
        new = pytree.tree_leaves(_like(call_args, spec))
        if len(new) != len(static):
            raise ValueError(f"{len(new)} leaves, captured with "
                             f"{len(static)}")
        for i, (t, dst) in enumerate(zip(new, static)):
            src, version = copied[i]
            if t is not src or t._version != version:
                dst.copy_(t)
                copied[i] = (t, t._version)
        graph.replay()
        return pytree.tree_map(lambda x: x.clone(), out)

    replay.graph = graph
    return replay


def device_put_tree_batched(params, device="cuda"):
    """A tree of host arrays on ``device`` with one host-to-device copy per
    dtype: the leaves of a dtype are packed into one (pinned, on CUDA)
    host buffer, copied at once, and each leaf is a view into the device
    buffer (JAX runtime/aot.py:87-120)."""
    device = torch.device(device)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [torch.from_numpy(np.ascontiguousarray(x))
              if isinstance(x, np.ndarray) else x for x in leaves]
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    out = [None] * len(leaves)
    for dtype, idxs in groups.items():
        total = sum(leaves[i].numel() for i in idxs)
        host = torch.empty(total, dtype=dtype,
                           pin_memory=device.type == "cuda")
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            host[off:off + n].copy_(leaves[i].reshape(-1))
            off += n
        dev = host.to(device, non_blocking=True)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            out[i] = dev[off:off + n].view(leaves[i].shape)
            off += n
    return pytree.tree_unflatten(out, spec)


def torch_layout(value: np.ndarray, kind: str) -> np.ndarray:
    """A native npz leaf in the port's layout (params.py): conv HWIO ->
    OIHW, dense [in, out] -> [out, in], others as they are."""
    if kind == "conv":
        value = value.transpose(3, 2, 0, 1)
    elif kind == "dense":
        value = value.T
    return np.ascontiguousarray(value)


def load_packed(pack_dir: str, device="cuda"):
    """Load a ``cli.main pack`` directory: (config, params, fn).
    ``fn(params, images)`` runs the exported forward at the packed batch
    shape and gives the live forward's output dict; on CUDA it is
    captured into one CUDA graph at its first call (``aot_compile``) and
    replayed after, for any params tree of the same names, shapes and
    dtypes on that device. ``params`` is the pack's flat dict (native npz
    names, the port's layouts, the pack's dtypes), uploaded by
    ``device_put_tree_batched``. Needs no model class: the kernels come
    from the pack's ``kernels/`` where their hashed names match this
    tree's sources, else from an nvcc build. ``fn.load_seconds`` splits
    the load: kernels, params read, params upload, graph."""
    import dataclasses

    from ..config import DetectorConfig
    device = torch.device(device)
    with open(os.path.join(pack_dir, "config.json")) as f:
        raw = json.load(f)
    pack = raw.pop("pack")
    if pack["torch"] != torch.__version__:
        raise RuntimeError(
            f"{pack_dir} was packed by torch {pack['torch']}; this is torch "
            f"{torch.__version__}: repack it with this torch")
    if pack["device"] != device.type:
        raise RuntimeError(f"{pack_dir} was packed for {pack['device']}, "
                           f"not {device.type}")
    fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    cfg = DetectorConfig.from_json(json.dumps(
        {k: v for k, v in raw.items() if k in fields}))
    seconds = {}
    t0 = time.perf_counter()
    if device.type == "cuda":
        enable_persistent_cache(os.path.join(pack_dir, "kernels"))
        for name in pack["kernels"]:
            native.load_cuda(name)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kinds = pack["layout"]
    with np.load(os.path.join(pack_dir, "params.npz")) as data:
        host = {name: torch_layout(data[name], kinds.get(name, "plain"))
                for name in data.files}
    seconds["params_read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = device_put_tree_batched(host, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["params_upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(os.path.join(pack_dir, "forward.pt2"), "rb") as f:
        call = load_exported(f.read(), device)
    seconds["graph"] = time.perf_counter() - t0
    if device.type != "cuda":
        call.load_seconds = seconds
        return cfg, params, call
    state = {}

    def fn(params, images):
        if "replay" not in state:
            state["replay"] = aot_compile(call, params, images)
        return state["replay"](params, images)

    fn.exported = call
    fn.load_seconds = seconds
    return cfg, params, fn
