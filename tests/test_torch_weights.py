"""The port's checkpoint loading against the JAX package's, on the CPU.

* utils/tf_ckpt.py: bundles written from the format's specs (the JAX
  tests' ``write_bundle``, extended here with bfloat16 entries and a
  snappy-compressed index block) give the port's ``load_tf_checkpoint``
  the dict JAX's gives, bit for bit, through a directory (with and without
  its ``checkpoint`` state file), a prefix and an ``.index`` path.
* utils/weights.py ``load_weights``: a tiny R18 with the mask head and
  EfficientDet ``efficientdet-test``, their trees written as a TF-named
  npz, a TF bundle (as a prefix and as a directory), the native npz, a
  partial native npz, a native npz with an extra name or a wrong shape,
  and automl npz files and bundles. On every leaf the checkpoint holds,
  the port's tree equals JAX's bit for bit; the key sets and shapes are
  JAX's; both raise the same error where one raises, print the same
  report, and drop the same names under ``ignore_vars``. A leaf the
  checkpoint lacks keeps each package's own init (the port's seeded
  ``init_params``, JAX's ``PRNGKey(0)`` init): only its shape is compared.
* One R18 forward of the port loaded from the TF-named npz against JAX's
  forward loaded by JAX's ``load_weights``, at tests/test_torch_forward.py's
  tolerance (checks the fc6 row permutation end to end).

JAX's loaders get the port's init as their model's init (JAX's eager
init takes ~20 s on the CPU for either model), and JAX's key set and
shapes come from ``jax.eval_shape`` of its own init: a leaf a checkpoint
lacks is compared by its shape alone, as above. Large trees are written
with ``write_bundle_ext`` (linear in the bytes; ``write_bundle`` appends
to one bytes object).
"""

import contextlib
import copy
import dataclasses
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.utils import effdet_weights as JEW  # noqa: E402
from object_detection_tracking_tpu.utils import tf_ckpt as JT  # noqa: E402
from object_detection_tracking_tpu.utils import weights as JW  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.params import init_params  # noqa: E402
from object_detection_tracking_tpu_torch.utils import tf_ckpt as TT  # noqa: E402
from object_detection_tracking_tpu_torch.utils import weights as TW  # noqa: E402
from tests.test_tf_ckpt import (_block, _bundle_entry, _handle,  # noqa: E402
                                _pb_varint, _varint, write_bundle)
from tests.test_weights import _to_tf_names  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import (SMALL, compare_forward, flat,  # noqa: E402
                               jax_params, port_config)


# --------------------------------------------------------------------------
# the TF bundle reader


def snappy_compress(data: bytes) -> bytes:
    """A snappy stream of ``data`` (format_description.txt): literals of up
    to 60 bytes and 1-byte-offset copies (length 4-11, offset < 2048) of
    earlier 4-byte runs."""
    out = bytearray(_varint(len(data)))
    seen, i, start = {}, 0, 0

    def literal(a, b):
        while a < b:
            n = min(60, b - a)
            out.append((n - 1) << 2)
            out.extend(data[a:a + n])
            a += n
    while i + 4 <= len(data):
        j = seen.get(data[i:i + 4])
        seen[data[i:i + 4]] = i
        if j is None or not 0 < i - j < 2048:
            i += 1
            continue
        n = 4
        while i + n < len(data) and n < 11 and data[j + n] == data[i + n]:
            n += 1
        literal(start, i)
        off = i - j
        out += bytes([((off >> 8) << 5) | ((n - 4) << 2) | 1, off & 0xFF])
        i += n
        start = i
    literal(start, len(data))
    return bytes(out)


def write_bundle_ext(prefix, tensors, snappy=False):
    """``write_bundle`` with bfloat16 entries (a tensor given as
    ("bfloat16", float32 array) is stored as its upper 16 bits, TF's
    DT_BFLOAT16) and, with ``snappy``, the index's data block
    snappy-compressed (block type 1)."""
    chunks, entries, offset = [], [], 0
    for name in sorted(tensors):
        arr = tensors[name]
        if isinstance(arr, tuple):
            arr = np.ascontiguousarray(arr[1], np.float32)
            raw = (arr.view(np.uint32) >> 16).astype("<u2").tobytes()
            enum = 14
        else:
            arr = np.ascontiguousarray(arr)
            raw = arr.tobytes()
            enum = {np.dtype(np.float32): 1, np.dtype(np.int64): 9,
                    np.dtype(np.int32): 3}[arr.dtype]
        entries.append((name.encode(), _bundle_entry(enum, arr.shape, 0,
                                                     offset, len(raw))))
        chunks.append(raw)
        offset += len(raw)
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        f.write(b"".join(chunks))
    block = _block([(b"", _pb_varint(1, 1))] + entries)
    if snappy:
        packed = snappy_compress(block)
        assert JT.snappy_decompress(packed) == block
        assert any(b & 3 == 1 for b in packed[1:])   # holds a copy op
        block, kind = packed, b"\x01"
    else:
        kind = b"\x00"
    out = block + kind + b"\x00" * 4
    meta = _block([])
    meta_handle = _handle(len(out), len(meta))
    out += meta + b"\x00" * 5
    index = _block([(b"\xff", _handle(0, len(block)))])
    idx_handle = _handle(len(out), len(index))
    out += index + b"\x00" * 5
    footer = meta_handle + idx_handle
    footer += b"\x00" * (40 - len(footer))
    footer += (0xdb4775248b80fb57).to_bytes(8, "little")
    with open(f"{prefix}.index", "wb") as f:
        f.write(out + footer)


def bundle_tensors(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "conv0/W": rng.randn(3, 3, 3, 8).astype(np.float32),
        "group0/block0/conv1/bn/mean/EMA": rng.randn(8).astype(np.float32),
        "group0/block0/conv1/bn/variance/EMA": rng.rand(8).astype(
            np.float32),
        "fpn/lateral_1x1_c2/W": rng.randn(1, 1, 8, 4).astype(np.float32),
        "global_step": np.array(1234, np.int64),
        "scalar": np.array(7, np.int32),
        "empty": np.zeros((0, 3), np.float32),
    }


def assert_same_dict(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == \
            ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("kind", ["plain", "bfloat16", "snappy"])
def test_bundle_reader_matches_jax(tmp_path, kind):
    tensors = bundle_tensors()
    if kind == "bfloat16":
        rng = np.random.RandomState(1)
        tensors["fastrcnn/fc6/W"] = ("bfloat16",
                                     rng.randn(12, 5).astype(np.float32))
        tensors["rpn/conv0/b"] = ("bfloat16", np.array(
            [0.0, -0.0, 1.0, -2.5, 3e38, 1e-40], np.float32))
    prefix = str(tmp_path / "model.ckpt")
    if kind == "plain":
        write_bundle(prefix, {k: v for k, v in tensors.items()})
    else:
        write_bundle_ext(prefix, tensors, snappy=kind == "snappy")
    ref = JT.load_tf_checkpoint(prefix)
    got = TT.load_tf_checkpoint(prefix)
    assert_same_dict(got, ref)
    assert TT.list_tf_checkpoint(prefix) == JT.list_tf_checkpoint(prefix)
    if kind == "bfloat16":
        bits = got["fastrcnn/fc6/W"].view(np.uint32)
        assert not (bits & 0xFFFF).any()    # the upper 16 bits, widened
        want = tensors["fastrcnn/fc6/W"][1]
        np.testing.assert_allclose(got["fastrcnn/fc6/W"], want, rtol=2 ** -7)
    else:
        np.testing.assert_array_equal(got["conv0/W"], tensors["conv0/W"])


@pytest.mark.parametrize("how", ["directory", "directory_no_state",
                                 "prefix", "index"])
def test_bundle_path_resolution_matches_jax(tmp_path, how):
    older = str(tmp_path / "model.ckpt-100")
    newer = str(tmp_path / "model.ckpt-5000")
    write_bundle(older, {"x": np.arange(4, dtype=np.float32)})
    write_bundle_ext(newer, {"x": np.arange(6, dtype=np.float32)},
                     snappy=True)
    if how == "directory":
        # the state file names the older one: it wins over the sort order
        (tmp_path / "checkpoint").write_text(
            'model_checkpoint_path: "model.ckpt-100"\n')
    path = {"directory": str(tmp_path), "directory_no_state": str(tmp_path),
            "prefix": newer, "index": newer + ".index"}[how]
    ref = JT.load_tf_checkpoint(path)
    assert_same_dict(TT.load_tf_checkpoint(path), ref)
    assert ref["x"].size == (4 if how == "directory" else 6)
    assert TT._resolve_prefix(path) == JT._resolve_prefix(path)


# --------------------------------------------------------------------------
# load_weights: R18 with the mask head


R18 = DetectorConfig(num_class=5, resnet_depth=18, add_mask=True,
                     fpn_frcnn_fc_head_dim=64, **SMALL)


def jax_shapes(jm):
    """JAX's init tree's shapes by path (``jax.eval_shape``, no draws)."""
    return {k: v.shape for k, v in flat(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))).items()}


@pytest.fixture(scope="module")
def r18():
    """(JAX model whose loader starts from the port's init, the port's
    model, the tree to write: that init with the 0.2 BN-gamma scaling of
    torch_port_common.jax_params, JAX's init's shapes by path)."""
    jm = jax_model(R18)
    shapes = jax_shapes(jm)
    base = init_params(port_config(R18), seed=0)
    jm.init_params = lambda key: copy.deepcopy(base)
    return jm, get_model(port_config(R18)), jax_params(jm), shapes


def tf_named(tree, fpn_channels, suffix=":0"):
    """The reference's names for ``tree`` (tests/test_weights.py
    _to_tf_names), fc6's rows C-major, an optimizer slot and global_step
    beside them, each name ending in ``suffix``."""
    names = {k[:-2]: v for k, v in _to_tf_names(tree).items()}
    fc6 = names["fastrcnn/fc6/W"]
    d = fc6.shape[1]
    names["fastrcnn/fc6/W"] = fc6.reshape(7, 7, fpn_channels, d).transpose(
        2, 0, 1, 3).reshape(-1, d)
    names["fastrcnn/fc7/W/Momentum"] = np.zeros_like(names["fastrcnn/fc7/W"])
    names["global_step"] = np.array(99, np.int64)
    return {k + suffix: v for k, v in names.items()}


def write_checkpoint(tmp_path, fmt, tree, fpn_channels):
    """Writes ``tree`` in format ``fmt``; returns (path, the checkpoint's
    tree paths: the leaves it holds)."""
    leaves = flat(tree)
    held = set(leaves)
    if fmt in ("tf_npz", "tf_bundle", "tf_bundle_dir"):
        if fmt == "tf_npz":
            path = str(tmp_path / "ref.npz")
            np.savez(path, **tf_named(tree, fpn_channels))
        else:
            path = str(tmp_path / "model.ckpt-99")
            write_bundle_ext(path, tf_named(tree, fpn_channels, ""))
            if fmt == "tf_bundle_dir":
                (tmp_path / "checkpoint").write_text(
                    'model_checkpoint_path: "model.ckpt-99"\n')
                path = str(tmp_path)
        return path, held
    flat_w = dict(leaves)
    if fmt == "partial":
        for k in ("resnet/group0/block1/conv2/bn/gamma", "maskrcnn/fcn1/W"):
            held.discard(k)
            del flat_w[k]
    elif fmt == "extra":
        flat_w["fastrcnn/bogus/W"] = np.zeros((2, 2), np.float32)
    elif fmt == "shape":
        flat_w["fastrcnn/fc7/b"] = np.zeros((3,), np.float32)
    path = str(tmp_path / f"{fmt}.npz")
    np.savez(path, **flat_w)
    return path, held


def both_load(path, jm, tm, ignore_vars=None):
    """(JAX result or exception, its printout, port result or exception,
    its printout)."""
    out = []
    for fn, m in ((JW.load_weights, jm), (TW.load_weights, tm)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                res = fn(path, m, ignore_vars=ignore_vars)
                res = flat(jax.tree.map(np.asarray, res))
            except (KeyError, ValueError) as e:
                res = e
        out += [res, buf.getvalue().replace(path, "<path>")]
    return out


def assert_loads_like_jax(ref, got, held):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32, k
    assert held and held <= set(ref)
    for k in held:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["tf_npz", "tf_bundle", "tf_bundle_dir",
                                 "native", "partial", "extra", "shape"])
def test_r18_load_weights_matches_jax(tmp_path, r18, fmt):
    jm, tm, tree, shapes = r18
    path, held = write_checkpoint(tmp_path, fmt, tree, R18.fpn_num_channel)
    ref, ref_out, got, got_out = both_load(path, jm, tm)
    assert got_out == ref_out
    if fmt in ("extra", "shape"):
        assert type(got) is type(ref) is (KeyError if fmt == "extra"
                                          else ValueError)
        assert str(got) == str(ref)
        return
    assert {k: v.shape for k, v in got.items()} == shapes
    assert_loads_like_jax(ref, got, held)
    if fmt == "partial":
        # a leaf it lacks keeps the init, not the tree's value (x0.2)
        k = "resnet/group0/block1/conv2/bn/gamma"
        assert not np.array_equal(got[k], flat(tree)[k])
        np.testing.assert_array_equal(
            got[k], flat(init_params(port_config(R18), seed=0))[k])
    if fmt.startswith("tf"):
        assert "loaded" in got_out and "global_step" not in got_out


@pytest.mark.parametrize("fmt", ["tf_npz", "tf_bundle", "native"])
def test_ignore_vars_drop_the_same_names_as_jax(tmp_path, r18, fmt):
    jm, tm, tree, _ = r18
    path, held = write_checkpoint(tmp_path, fmt, tree, R18.fpn_num_channel)
    ignore = "fc6:maskrcnn/fcn0:/bn/gamma"
    ref, ref_out, got, got_out = both_load(path, jm, tm, ignore_vars=ignore)
    assert got_out == ref_out and ref_out.count("ignored ") > 10
    kept = {k for k in held if not any(
        s in k for s in ("fc6", "maskrcnn/fcn0", "/bn/gamma"))}
    assert_loads_like_jax(ref, got, kept)
    k = "resnet/group0/block1/conv2/bn/gamma"     # ignored: the init's
    assert not np.array_equal(got[k], flat(tree)[k])


def test_tf_named_forward_matches_jax_loaded_forward(tmp_path, r18):
    """The port loaded from the reference-named npz (fc6 rows C-major)
    runs the forward JAX runs on JAX's load of the same file. The models
    have no mask head (JAX's eager mask head takes ~30 s on the CPU): both
    loaders report the mask head's names as not mapped."""
    _, _, tree, _ = r18
    path, _ = write_checkpoint(tmp_path, "tf_npz", tree, R18.fpn_num_channel)
    cfg = dataclasses.replace(R18, add_mask=False)
    jm = jax_model(cfg)
    base = init_params(port_config(cfg), seed=0)
    jm.init_params = lambda key: copy.deepcopy(base)
    ref, ref_out, got, got_out = both_load(path, jm,
                                           get_model(port_config(cfg)))
    assert got_out == ref_out and "not mapped" in got_out
    imgs = np.random.RandomState(1).randint(0, 256, (2, 64, 96, 3)).astype(
        np.uint8)
    compare_forward(port_config(cfg), nest(got), imgs, ref_params=nest(ref),
                    jit=True)


def nest(leaves):
    """The nested tree of {"a/b/W": leaf}."""
    tree = {}
    for k, v in leaves.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# --------------------------------------------------------------------------
# load_weights: EfficientDet


EFFDET = DetectorConfig.coco_partial(result_per_im=10, compute_dtype="float32",
                                     efficientdet_name="efficientdet-test",
                                     roi_align_impl="xla")


@pytest.fixture(scope="module")
def effdet():
    """(JAX EfficientDet whose loader starts from the port's init, the
    port's model, a tree with every leaf drawn from N(0, 1), JAX's init's
    shapes by path)."""
    from object_detection_tracking_tpu.models.efficientdet import \
        EfficientDet as JE
    jm = JE(EFFDET)
    shapes = jax_shapes(jm)
    base = init_params(port_config(EFFDET), 0, "efficientdet")
    jm.init_params = lambda key: copy.deepcopy(base)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda v: rng.standard_normal(v.shape, np.float32),
                        base)
    return jm, get_model(port_config(EFFDET), "efficientdet"), tree, shapes


@pytest.mark.parametrize("fmt", ["automl_npz", "automl_bundle", "native",
                                 "partial", "extra"])
def test_effdet_load_weights_matches_jax(tmp_path, effdet, fmt):
    from test_torch_effdet_params import automl_dict
    jm, tm, tree, shapes = effdet
    held = set(flat(tree))
    if fmt.startswith("automl"):
        weights = automl_dict(jm, tree)
        if fmt == "automl_npz":
            path = str(tmp_path / "automl.npz")
            np.savez(path, **weights)
        else:
            path = str(tmp_path / "model.ckpt")
            write_bundle_ext(path, {k[:-2]: np.asarray(v)
                                    for k, v in weights.items()})
        held = {"/".join(p) for p, _ in JEW.effdet_name_map(jm).values()}
    else:
        flat_w = flat(tree)
        if fmt == "partial":
            for k in ("class_net/predict/pw/W", "backbone/stem/bn/mean"):
                held.discard(k)
                del flat_w[k]
        elif fmt == "extra":
            flat_w["box_net/bogus/W"] = np.zeros((2,), np.float32)
        path = str(tmp_path / f"{fmt}.npz")
        np.savez(path, **flat_w)
    ref, ref_out, got, got_out = both_load(path, jm, tm)
    assert got_out == ref_out
    if fmt == "extra":
        assert type(got) is type(ref) is KeyError
        assert str(got) == str(ref)
        return
    assert {k: v.shape for k, v in got.items()} == shapes
    assert_loads_like_jax(ref, got, held)
    if fmt.startswith("automl"):
        assert "loaded" in got_out
