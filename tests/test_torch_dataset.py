"""The port's dataset layer against ``keystone_tpu.parallel.dataset``.

The JAX package pads rows to a multiple of the mesh's data shards (8 on
the test mesh); the port keeps the same padding and mask semantics on
one device through ``shards``. Comparisons are exact: padding, masks and
row selection move values without arithmetic.
"""
import numpy as np
import pytest
import torch

from keystone_tpu.parallel import dataset as jds
from keystone_tpu_torch.parallel import dataset as tds

SHARDS = 8


def _rows(n, d=3, seed=0):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


@pytest.mark.parametrize("n", [1, 5, 8, 13, 64])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_padded_rows_matches_reference(n, shards):
    assert tds.padded_rows(n, shards) == jds.padded_rows(n, shards)


@pytest.mark.parametrize("n", [5, 8, 13])
def test_padding_mask_and_n_match_reference(mesh8, n):
    x = _rows(n)
    ref = jds.ArrayDataset.from_numpy(x)
    port = tds.ArrayDataset.from_numpy(x, "cpu", shards=SHARDS)
    assert port.n == ref.n == n
    assert port.padded_n == ref.padded_n
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.numpy(), ref.numpy())
    assert len(port) == len(ref)


def test_map_batch_rezeroes_padding_like_reference(mesh8):
    x = _rows(13)
    ref = jds.ArrayDataset.from_numpy(x).map_batch(lambda X: X + 1.0)
    port = tds.ArrayDataset.from_numpy(x, "cpu", shards=SHARDS).map_batch(
        lambda X: X + 1.0)
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    assert float(port.data[13:].abs().sum()) == 0.0


def test_map_applies_per_item_function(mesh8):
    x = _rows(6)
    ref = jds.ArrayDataset.from_numpy(x).map(lambda v: v * 2.0)
    port = tds.ArrayDataset.from_numpy(x, "cpu", shards=SHARDS).map(
        lambda v: v * 2.0)
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=0, atol=0)
    assert port.padded_n == ref.padded_n


def test_zip_and_collect(mesh8):
    x, y = _rows(5), _rows(5, seed=1)
    ref = jds.ArrayDataset.from_numpy(x).zip(jds.ArrayDataset.from_numpy(y))
    port = tds.ArrayDataset.from_numpy(x, "cpu", shards=SHARDS).zip(
        tds.ArrayDataset.from_numpy(y, "cpu", shards=SHARDS))
    rn, pn = ref.numpy(), port.numpy()
    assert isinstance(pn, tuple) and len(pn) == 2
    for a, b in zip(pn, rn):
        np.testing.assert_array_equal(a, b)
    items = port.collect()
    assert len(items) == 5
    np.testing.assert_array_equal(items[3][1].numpy(), y[3])
    with pytest.raises(ValueError):
        port.zip(tds.ArrayDataset.from_numpy(_rows(4), "cpu"))


def test_host_dataset_and_coercions():
    items = [np.full(3, i, np.float32) for i in range(4)]
    host = tds.HostDataset(items)
    assert len(host) == 4
    dev = tds.ensure_array(host, "cpu")
    assert isinstance(dev, tds.ArrayDataset) and dev.n == 4
    np.testing.assert_array_equal(dev.numpy(), np.stack(items))
    np.testing.assert_array_equal(tds.to_numpy(host), np.stack(items))
    np.testing.assert_array_equal(tds.to_numpy(dev), np.stack(items))
    assert isinstance(tds.as_dataset(["a", "b"], "cpu"), tds.HostDataset)
    assert isinstance(tds.as_dataset(items, "cpu"), tds.ArrayDataset)
    arr = tds.as_dataset(np.stack(items), "cpu")
    assert tds.ensure_array(arr) is arr
    np.testing.assert_array_equal(
        tds.to_numpy(torch.arange(3)), np.arange(3))


@pytest.mark.parametrize("form", ["tensor", "host_tensors"])
def test_ensure_array_keeps_tensors_where_they_lie(form):
    """With no device, a CPU tensor (raw, or as a host dataset's items)
    stays on the CPU."""
    x = torch.as_tensor(_rows(4))
    ds = x if form == "tensor" else tds.HostDataset(list(x))
    got = tds.ensure_array(ds)
    assert got.device.type == "cpu" and got.n == 4
    np.testing.assert_array_equal(got.numpy(), x.numpy())


def test_ensure_array_stages_host_arrays_on_the_default_device():
    """A numpy array lies on no device: with no device it goes to the
    default one, which raises where no card is present."""
    x = _rows(4)
    if torch.cuda.is_available():
        assert tds.ensure_array(x).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tds.ensure_array(x)
    assert tds.ensure_array(x, "cpu").device.type == "cpu"


def test_mean_over_true_n_matches_reference(mesh8):
    """Means divide by the true n, not the padded row count."""
    from keystone_tpu.ops.linalg import distributed_mean as jmean
    from keystone_tpu_torch.ops.linalg import distributed_mean as tmean

    x = _rows(13, d=4)
    ref = jds.ArrayDataset.from_numpy(x)
    port = tds.ArrayDataset.from_numpy(x, "cpu", shards=SHARDS)
    np.testing.assert_allclose(
        tmean(port.data, port.n).numpy(),
        np.asarray(jmean(ref.data, ref.n)), rtol=1e-6)
    np.testing.assert_allclose(tmean(port.data, port.n).numpy(),
                               x.mean(axis=0), rtol=1e-6)


def test_to_device_is_identity_on_same_device():
    ds = tds.ArrayDataset.from_numpy(_rows(3), "cpu")
    assert ds.to("cpu") is ds


def test_leading_dim_mismatch_raises():
    with pytest.raises(ValueError):
        tds.ArrayDataset(torch.zeros(4, 2), n=5, shards=4)


@pytest.mark.parametrize("packed", [False, True])
def test_cifar_loader_matches_reference(mesh8, tmp_path, packed):
    from keystone_tpu.loaders.cifar_loader import cifar_loader as jload
    from keystone_tpu_torch.loaders.cifar_loader import cifar_loader as tload

    rng = np.random.RandomState(0)
    for i in range(2):  # a directory of two binary batches
        rec = rng.randint(0, 256, (3 + i, 1 + 3072), dtype=np.uint8)
        rec[:, 0] = rng.randint(0, 10, 3 + i)
        (tmp_path / f"data_batch_{i}.bin").write_bytes(rec.tobytes())
    want = jload(str(tmp_path), packed=packed)
    got = tload(str(tmp_path), packed=packed, device="cpu")
    assert got.data.n == want.data.n == 7
    gx, wx = got.data.numpy(), want.data.numpy()
    assert gx.dtype == wx.dtype and gx.shape == (7, 32, 32, 3)
    # row-major, as the featurize kernel reads the images
    assert got.data.data.is_contiguous()
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels.numpy())
    assert got.data.tag == want.data.tag
    moved = got.to("cpu")
    assert moved.data is got.data and moved.labels is got.labels


def test_cifar_decode_rejects_a_truncated_buffer():
    from keystone_tpu_torch.loaders.cifar_loader import cifar_decode

    with pytest.raises(ValueError, match="corrupt"):
        cifar_decode(b"\x00" * 3000)
