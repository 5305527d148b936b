"""The port's command line and the apps that read their own data.

``python -m keystone_tpu_torch <app>`` runs VOCSIFTFisher and
ImageNetSiftLcsFV from tar archives and MnistRandomFFT from CSV files,
all written by the test at small sizes (VOC: 10 / 6 surrogate images at
64 x 80 and 80 x 64 as JPEG; ImageNet: 12 / 6 images of 3 classes at 64
x 80; MNIST: 96 / 48 rows), with ``--device cpu`` and small widths. Each
``run`` that reads from disk must give exactly what ``run`` gives on the
datasets the loader returns (the same fit on the same data: equal
scores, no tolerance). The mains take the JAX package's flags and
defaults (their configs compared field by field), plus ``--device``;
what the port has not yet exits 2 naming its ROADMAP item, and the
``check``, ``benchdiff`` and ``numerics`` subcommands exit as the JAX
package's do on the same arguments. The text
apps' mains are driven from files in ``tests/test_torch_text_apps.py``.
"""
import importlib
import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from keystone_tpu import __main__ as jmain
from keystone_tpu_torch import __main__ as tmain
from keystone_tpu_torch.loaders import (
    VOCDataPath,
    VOCLabelPath,
    csv_labeled_loader,
    imagenet_loader,
    voc_loader,
)
from keystone_tpu_torch.loaders.surrogate import (
    make_surrogate_imagenet,
    make_surrogate_mnist,
    make_surrogate_voc,
)
from keystone_tpu_torch.parallel.dataset import to_numpy
from keystone_tpu_torch.pipelines.images.imagenet import sift_lcs_fv as inet
from keystone_tpu_torch.pipelines.images.mnist import random_fft
from keystone_tpu_torch.pipelines.images.voc import voc_sift_fisher as voc
from keystone_tpu_torch.workflow.env import PipelineEnv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_env():
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _jpeg(img):
    buf = io.BytesIO()
    Image.fromarray(np.asarray(np.rint(img), np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _tar(path, members):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def voc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc")
    train, test = make_surrogate_voc(10, 6, seed=0,
                                     sizes=((64, 80), (80, 64)))
    rows = ["name,cls,x,y,file"]
    for split, ds in (("train", train), ("test", test)):
        members = []
        for i, it in enumerate(ds.collect()):
            name = f"{split}{i:04d}.jpg"
            members.append((voc.IMAGES_PREFIX + name, _jpeg(it.image)))
            rows += [f'x,{c + 1},a,b,"{name}"' for c in it.labels]
        _tar(str(d / split / "part0.tar"), members[:5])
        _tar(str(d / split / "part1.tar"), members[5:])
    (d / "labels.csv").write_text("\n".join(rows) + "\n")
    return str(d), train, test


VOC_FLAGS = ["--descDim", "8", "--vocabSize", "2", "--numPcaSamples", "400",
             "--numGmmSamples", "400"]


def _printed(capsys, prefix):
    out = capsys.readouterr().out
    return next(line for line in out.splitlines() if line.startswith(prefix))


def test_voc_main_reads_tars_and_writes_a_trace(voc_files, tmp_path, capsys):
    d, _, _ = voc_files
    trace = str(tmp_path / "voc.json")
    assert tmain.main([
        "voc.sift_fisher", "--trainLocation", f"{d}/train",
        "--testLocation", f"{d}/test", "--labelPath", f"{d}/labels.csv",
        *VOC_FLAGS, "--device", "cpu", "--trace-out", trace]) == 0
    vmap = float(_printed(capsys, "TEST MAP is:").split(":")[1])
    assert 0.0 < vmap <= 1.0
    blob = json.load(open(trace))
    assert blob["name"] == "voc.sift_fisher" and blob["nodes"]
    perfetto = str(tmp_path / "voc.perfetto.json")
    PipelineEnv.reset()
    assert tmain.main([
        "voc.sift_fisher", "--trainLocation", f"{d}/train",
        "--testLocation", f"{d}/test", "--labelPath", f"{d}/labels.csv",
        *VOC_FLAGS, "--device", "cpu", "--trace-out", perfetto]) == 0
    assert json.load(open(perfetto))["traceEvents"]


def test_voc_run_from_disk_is_run_on_the_loaded_datasets(voc_files):
    d, train, test = voc_files
    config = voc.SIFTFisherConfig(f"{d}/train", f"{d}/test",
                                  f"{d}/labels.csv", desc_dim=8,
                                  vocab_size=2, num_pca_samples=400,
                                  num_gmm_samples=400)
    _, ap = voc.run(config, device="cpu")
    loaded = [voc_loader(VOCDataPath(f"{d}/{s}", voc.IMAGES_PREFIX),
                         VOCLabelPath(f"{d}/labels.csv"))
              for s in ("train", "test")]
    # the loader keeps the surrogate's labels and order
    assert [it.labels for it in loaded[0].collect()] == [
        it.labels for it in train.collect()]
    assert [it.labels for it in loaded[1].collect()] == [
        it.labels for it in test.collect()]
    PipelineEnv.reset()
    _, ap2 = voc.run(config, *loaded, device="cpu")
    np.testing.assert_array_equal(ap, ap2)


@pytest.fixture(scope="module")
def imagenet_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    train, test = make_surrogate_imagenet(12, 6, seed=0, num_classes=3,
                                          h=64, w=80)
    for split, ds in (("train", train), ("test", test)):
        _tar(str(d / split / "a.tar"), [
            (f"n{it.label:05d}/{split}{i}.JPEG", _jpeg(it.image))
            for i, it in enumerate(ds.collect())])
    (d / "labels.txt").write_text("".join(f"n{c:05d} {c}\n"
                                          for c in range(3)))
    return str(d)


def test_imagenet_main_reads_tars(imagenet_files, capsys):
    d = imagenet_files
    assert tmain.main([
        "imagenet.sift_lcs_fv", "--trainLocation", f"{d}/train",
        "--testLocation", f"{d}/test", "--labelPath", f"{d}/labels.txt",
        "--descDim", "8", "--vocabSize", "2", "--device", "cpu"]) == 0
    line = _printed(capsys, "TEST top-5 error is")
    assert float(line.split()[-1].rstrip("%")) == 0.0  # 3 classes, top 5


def test_imagenet_run_from_disk_is_run_on_the_loaded_datasets(
        imagenet_files):
    d = imagenet_files
    config = inet.ImageNetSiftLcsFVConfig(
        f"{d}/train", f"{d}/test", f"{d}/labels.txt", desc_dim=8,
        vocab_size=2, lcs_stride=12, lcs_border=20, block_size=128)
    kw = dict(num_classes=3, top_k=2, sift_kwargs=dict(step=12,
                                                       num_scales=2),
              device="cpu")
    fitted, err = inet.run(config, **kw)
    train, test = (imagenet_loader(f"{d}/{s}", f"{d}/labels.txt")
                   for s in ("train", "test"))
    top = to_numpy(fitted(inet.images_on(test, "cpu")))
    PipelineEnv.reset()
    fitted2, err2 = inet.run(config, train, test, **kw)
    assert err == err2
    np.testing.assert_array_equal(
        top, to_numpy(fitted2(inet.images_on(test, "cpu"))))


def _mnist_csv(path, X, y):
    rows = np.concatenate([(y + 1)[:, None], np.rint(X * 255)], axis=1)
    np.savetxt(path, rows, delimiter=",", fmt="%d")
    return str(path)


def test_mnist_main_reads_csvs(tmp_path, capsys):
    (tx, ty), (vx, vy) = make_surrogate_mnist(96, 48)
    train = _mnist_csv(tmp_path / "train.csv", tx, ty)
    test = _mnist_csv(tmp_path / "test.csv", vx, vy)
    assert tmain.main(["mnist.random_fft", "--trainLocation", train,
                       "--testLocation", test, "--numFFTs", "2",
                       "--blockSize", "512", "--lambda", "10",
                       "--device", "cpu"]) == 0
    line = _printed(capsys, "TRAIN Error is")
    assert float(line.split()[-1].rstrip("%")) <= 5.0
    config = random_fft.MnistRandomFFTConfig(train, test, num_ffts=2,
                                             block_size=512, lam=10.0)
    PipelineEnv.reset()
    fitted, tr_eval, te_eval = random_fft.run(config, device="cpu")
    data = [csv_labeled_loader(p, label_offset=1, device="cpu")
            for p in (train, test)]
    np.testing.assert_array_equal(data[0].labels.numpy(), ty)
    PipelineEnv.reset()
    fitted2, tr2, te2 = random_fft.run(config, *data, device="cpu")
    assert tr_eval.total_error == tr2.total_error
    assert te_eval.total_error == te2.total_error
    np.testing.assert_array_equal(fitted(data[1].data).get().numpy(),
                                  fitted2(data[1].data).get().numpy())


# -- the registry ------------------------------------------------------------

PORTED = ["cifar.linear_pixels", "cifar.random_cifar", "cifar.random_patch",
          "cifar.random_patch_augmented", "imagenet.sift_lcs_fv",
          "mnist.random_fft", "nlp.stupid_backoff", "speech.timit",
          "text.amazon_reviews", "text.newsgroups", "voc.sift_fisher"]


def test_the_registry_is_the_jax_one_less_the_text_apps():
    """The text apps are ported too: the JAX registry less nothing."""
    assert sorted(tmain.APPS) == PORTED
    assert sorted(jmain.APPS) == PORTED
    for app, module in tmain.APPS.items():
        assert module == jmain.APPS[app].replace("keystone_tpu.",
                                                 "keystone_tpu_torch.", 1)
        assert callable(importlib.import_module(module).main)


def test_python_dash_m_lists_the_apps():
    out = subprocess.run([sys.executable, "-m", "keystone_tpu_torch"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    listed = [line.strip() for line in lines[lines.index("apps:") + 1:]]
    assert listed == PORTED


@pytest.mark.parametrize("argv,item", [
    (["text.newsgroups", "--trainLocation", "x", "--coordinator",
      "localhost:1234"], "A11"),
    (["text.amazon_reviews", "--num-processes", "2"], "A11"),
    (["nlp.stupid_backoff", "--process-id=0"], "A11"),
    (["check", "--all", "--shards", "8"], "A11"),
    (["check", "cifar.linear_pixels", "--xla"], "A12b"),
    (["voc.sift_fisher", "--coordinator", "localhost:1234"], "A11"),
    (["voc.sift_fisher", "--num-processes", "2"], "A11"),
    (["mnist.random_fft", "--process-id=0"], "A11"),
])
def test_what_is_not_ported_exits_2_naming_its_item(argv, item, capsys):
    assert tmain.main(argv) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP {item}" in err and "not ported" in err


def _postmortem(tmp_path, monkeypatch):
    from keystone_tpu_torch.observability.postmortem import dump_postmortem

    monkeypatch.setenv("KEYSTONE_TORCH_POSTMORTEM_DIR", str(tmp_path))
    return dump_postmortem("numerics_nan", {"chunk": 5})


@pytest.mark.parametrize("argv,code", [
    (["check", "cifar.linear_pixels"], 0),
    (["check", "cifar.linear_pixels", "--budget", "1MiB"], 2),
    (["benchdiff", "BENCH_r02.json", "BENCH_r01.json"], 2),
    (["numerics", "POSTMORTEM"], 0),
])
def test_the_subcommands_exit_as_the_jax_ones(argv, code, tmp_path,
                                              monkeypatch, capsys):
    argv = [os.path.join(REPO, a) if a.startswith("BENCH") else a
            for a in argv]
    if "POSTMORTEM" in argv:
        argv[argv.index("POSTMORTEM")] = _postmortem(tmp_path, monkeypatch)
    assert tmain.main(list(argv)) == code
    port_out = capsys.readouterr().out
    assert jmain.main(list(argv)) == code
    if argv[0] == "check":
        # the JAX command adds the tree-wide scans the port refers to
        # ROADMAP A12b / A11
        assert "not ported (ROADMAP A12b)" in port_out
        assert "concurrency: clean" not in port_out
    else:
        assert port_out == capsys.readouterr().out


def test_keystone_distributed_exits_2(monkeypatch, capsys):
    monkeypatch.setenv("KEYSTONE_DISTRIBUTED", "1")
    assert tmain.main(["voc.sift_fisher"]) == 2
    assert "ROADMAP A11" in capsys.readouterr().err
    assert tmain.main(["nope"]) == 2


def _configs(module, argv, monkeypatch):
    """The config each package's ``main`` hands its ``run``, and the
    port's devices with no ``--device`` and with ``--device cpu``."""
    jax_seen, port_seen = [], []
    jmod = importlib.import_module(jmain.APPS[module])
    tmod = importlib.import_module(tmain.APPS[module])
    monkeypatch.setattr(jmod, "run", lambda config, **kw:
                        jax_seen.append(config))
    monkeypatch.setattr(tmod, "run", lambda config, device:
                        port_seen.append((config, device)))
    jmod.main(argv)
    tmod.main(argv)
    tmod.main(argv + ["--device", "cpu"])
    return jax_seen[0], port_seen[0][0], port_seen[0][1], port_seen[1][1]


@pytest.mark.parametrize("app,argv", [
    ("voc.sift_fisher", ["--trainLocation", "a", "--testLocation", "b",
                         "--labelPath", "c", "--pcaFile", "p.csv"]),
    ("imagenet.sift_lcs_fv", ["--trainLocation", "a", "--testLocation", "b",
                              "--labelPath", "c", "--lcsGmmMeanFile", "m"]),
    ("mnist.random_fft", ["--trainLocation", "a", "--testLocation", "b",
                          "--numFFTs", "3"]),
    ("cifar.random_cifar", ["--trainLocation", "a", "--testLocation", "b"]),
    ("cifar.random_patch_augmented", ["--trainLocation", "a",
                                      "--testLocation", "b"]),
    ("speech.timit", ["--trainDataLocation", "a", "--trainLabelsLocation",
                      "b", "--testDataLocation", "c",
                      "--testLabelsLocation", "d", "--rfType", "cauchy"]),
    ("text.newsgroups", ["--trainLocation", "a", "--testLocation", "b",
                         "--nGrams", "3", "--lemmatize"]),
    ("text.amazon_reviews", ["--trainLocation", "a", "--testLocation", "b",
                             "--threshold", "4"]),
    ("nlp.stupid_backoff", ["--trainData", "a", "--n", "4"]),
])
def test_mains_take_the_jax_flags_and_defaults(app, argv, monkeypatch):
    jcfg, tcfg, default_device, device = _configs(app, argv, monkeypatch)
    assert tcfg.__dict__ == jcfg.__dict__
    assert (default_device, device) == ("cuda", "cpu")


def test_an_app_main_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tx, ty), _ = make_surrogate_mnist(4, 1)
    path = _mnist_csv(tmp_path / "m.csv", tx, ty)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["mnist.random_fft", "--trainLocation", path,
                    "--testLocation", path])
