"""Port vs reference: the data pipeline (``repro_torch.data``, a copy of
``repro.data``: the same batches bit for bit) and checkpoint/restart
(``repro_torch.checkpoint``: the reference's protocol on the port's trees),
with ``tests/test_substrate.py``'s data and checkpoint tests mirrored on the
port in their bf16 set-up, and the train CLI's resume.  The deterministic
resume on the card carries the ``cuda`` marker."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# one_torch_thread: an autouse fixture, imported to turn it on
from helpers.torch_lm import FAMILY_ARCH, one_torch_thread, reference, tree_np  # noqa: E402, F401

from repro.data import FileBackedLM as JFileBackedLM  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data import SyntheticLMConfig as JSyntheticLMConfig  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.convert import lm_from_numpy  # noqa: E402
from repro_torch.data import FileBackedLM, Prefetcher, SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.training import adamw, make_train_step, warmup_cosine  # noqa: E402


@pytest.mark.parametrize("frontend", ["none", "audio_frames", "vision_patches"])
@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (3, 2), (11, 4)])
def test_synthetic_batches_equal_the_references(frontend, seed, n_hosts):
    kw = dict(vocab_size=97, seq_len=16, global_batch=8, seed=seed, frontend=frontend,
              frontend_dim=0 if frontend == "none" else 8, n_patches=4)
    for host in range(n_hosts):
        ours = SyntheticLM(SyntheticLMConfig(**kw), host=host, n_hosts=n_hosts)
        ref = JSyntheticLM(JSyntheticLMConfig(**kw), host=host, n_hosts=n_hosts)
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, step)


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_file_backed_batches_equal_the_references(tmp_path, n_hosts):
    tokens = (np.arange(10_000, dtype=np.int32) * 7) % 97
    FileBackedLM.write_corpus(tmp_path / "ours", tokens, n_hosts=n_hosts)
    JFileBackedLM.write_corpus(tmp_path / "ref", tokens, n_hosts=n_hosts)
    for host in range(n_hosts):
        ours = FileBackedLM(tmp_path / "ours", seq_len=16, local_batch=4, host=host,
                            n_hosts=n_hosts)
        ref = JFileBackedLM(tmp_path / "ref", seq_len=16, local_batch=4, host=host,
                            n_hosts=n_hosts)
        for step in (0, 3, 50):
            a, b = ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
            assert a.shape == (4, 16) and a.dtype == b.dtype and np.array_equal(a, b)


def test_data_pipeline_determinism_and_elasticity():
    cfg = SyntheticLMConfig(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    one_host = SyntheticLM(cfg, host=0, n_hosts=1)
    two_a = SyntheticLM(cfg, host=0, n_hosts=2)
    two_b = SyntheticLM(cfg, host=1, n_hosts=2)
    b1 = one_host.batch_at(7)
    assert (one_host.batch_at(7)["tokens"] == b1["tokens"]).all()
    a = two_a.batch_at(7)["tokens"]
    b = two_b.batch_at(7)["tokens"]
    assert a.shape == (4, 16) and b.shape == (4, 16)
    assert not (a == b).all()
    with pytest.raises(ValueError, match="divide"):
        SyntheticLM(cfg, n_hosts=3)


def test_prefetcher_orders_steps():
    cfg = SyntheticLMConfig(vocab_size=50, seq_len=8, global_batch=2)
    source = SyntheticLM(cfg)
    pf = Prefetcher(source, start_step=5, depth=2)
    try:
        got = [pf.next() for _ in range(4)]
        assert [s for s, _ in got] == [5, 6, 7, 8]
        for s, batch in got:
            assert np.array_equal(batch["tokens"], source.batch_at(s)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_setup():
    """tests/test_substrate.py's set-up on the port (bf16 ``qwen1.5-4b``
    reduced, the reference's initial weights)."""
    cfg, _, params = reference(FAMILY_ARCH["dense"], "bfloat16")
    host = tree_np(params)
    opt = adamw(warmup_cosine(2e-2, 3, 100), weight_decay=0.01)
    data = SyntheticLM(SyntheticLMConfig(cfg.vocab_size, seq_len=32, global_batch=8))

    def fresh():
        model = lm_from_numpy(cfg, host, device="cpu")
        return model, opt.init(dict(model.named_parameters()))
    return opt, data, fresh


def _batch(data, step, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in data.batch_at(step).items()}


def _resume_is_bitwise(opt, data, fresh, root, device="cpu"):
    """Train 6 steps with a checkpoint at 3, "crash", restore into a fresh
    model and replay steps 4-6: the parameters must be bit-identical."""
    model, opt_state = fresh()
    step_fn = make_train_step(model, opt)
    for step in range(6):
        model, opt_state, _ = step_fn(model, opt_state, _batch(data, step, device))
        if step == 2:
            ckpt.save(root, step + 1, {"params": model.state_dict(), "opt": opt_state},
                      extra={"data_step": step + 1})
    want = {k: v.detach().clone() for k, v in model.named_parameters()}

    model, opt_state = fresh()
    step, tree, extra = ckpt.restore(root, {"params": model.state_dict(), "opt": opt_state})
    assert step == 3 and extra["data_step"] == 3
    model.load_state_dict(tree["params"])
    opt_state = tree["opt"]
    assert opt_state["step"].dtype == torch.int32 and int(opt_state["step"]) == 3
    step_fn = make_train_step(model, opt)
    for s in range(extra["data_step"], 6):
        model, opt_state, _ = step_fn(model, opt_state, _batch(data, s, device))
    for k, p in model.named_parameters():
        assert p.dtype == want[k].dtype and torch.equal(p.detach(), want[k]), k


def test_checkpoint_resume_bitwise(tiny_setup, tmp_path):
    _resume_is_bitwise(*tiny_setup, tmp_path)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_checkpoint_resume_bitwise_on_the_card(tiny_setup, tmp_path, cuda_device,
                                               monkeypatch):
    """On the card the embedding's backward accumulates with atomics, so
    the run is deterministic only under ``use_deterministic_algorithms``
    (which needs ``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    opt, data, fresh = tiny_setup

    def fresh_on_card():
        model, _ = fresh()
        model = model.to(cuda_device)
        return model, opt.init(dict(model.named_parameters()))
    torch.use_deterministic_algorithms(True)
    try:
        _resume_is_bitwise(opt, data, fresh_on_card, tmp_path, cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)


def test_checkpoint_rotation_and_atomicity(tmp_path):
    tree = {"a": torch.arange(5), "b": torch.ones((2, 2), dtype=torch.bfloat16)}
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, tree, keep=2)
    names = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert names == ["step_0000000003", "step_0000000004"]
    assert ckpt.latest_step(tmp_path) == 4
    # a stale tmp dir must never be picked up
    (tmp_path / ".tmp_step_0000000009").mkdir()
    assert ckpt.latest_step(tmp_path) == 4
    _, restored, _ = ckpt.restore(tmp_path, tree)
    assert restored["b"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], tree["a"])


def test_checkpoint_layout_and_bf16_exactness(tmp_path):
    rng = np.random.default_rng(0)
    bf = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).to(torch.bfloat16)
    tree = {"z": {"w": bf, "n": torch.tensor(7, dtype=torch.int32)},
            "a": torch.linspace(0, 1, 4, dtype=torch.float64)}
    final = ckpt.save(tmp_path, 12, tree, extra={"note": "x"})
    manifest = json.loads((final / "manifest.json").read_text())
    assert manifest["n_leaves"] == 3 and manifest["step"] == 12
    assert manifest["keys"] == ["a", "z/n", "z/w"]           # sorted-key order
    assert manifest["dtypes"] == ["float64", "int32", "bfloat16"]
    assert np.load(final / "arr_00002.npy").dtype == np.float32
    assert (tmp_path / "LATEST").read_text() == "step_0000000012"
    step, got, extra = ckpt.restore(tmp_path, tree)
    assert step == 12 and extra == {"note": "x"}
    assert got["z"]["w"].dtype == torch.bfloat16 and torch.equal(got["z"]["w"], bf)
    assert torch.equal(got["z"]["n"], tree["z"]["n"]) and torch.equal(got["a"], tree["a"])


def test_restore_refuses_another_structure(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, {"a": torch.zeros(3), "c": torch.zeros(2)})
    with pytest.raises(ValueError, match="b: "):
        ckpt.restore(tmp_path, {"a": torch.zeros(3), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="b: "):
        ckpt.restore(tmp_path, {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", {"a": torch.zeros(3)})


def test_async_checkpoint(tmp_path):
    tree = {"w": torch.arange(12).reshape(3, 4)}
    t = ckpt.save_async(tmp_path, 7, tree)
    t.join(timeout=30)
    assert not t.is_alive()
    s, restored, _ = ckpt.restore(tmp_path, tree)
    assert s == 7 and torch.equal(restored["w"], torch.arange(12).reshape(3, 4))


def test_async_checkpoint_copies_before_returning(tmp_path, monkeypatch):
    """The host copy is taken before ``save_async`` returns, so the train
    loop may write its tensors in place while the thread writes the
    files."""
    release = threading.Event()
    real_save = ckpt.checkpoint.save

    def slow_save(*a, **kw):
        release.wait(timeout=30)
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt.checkpoint, "save", slow_save)
    w = torch.arange(6, dtype=torch.float32)
    t = ckpt.save_async(tmp_path, 1, {"w": w})
    w.add_(100)                      # the next step writes in place
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    _, restored, _ = ckpt.restore(tmp_path, {"w": w})
    assert torch.equal(restored["w"], torch.arange(6, dtype=torch.float32))
