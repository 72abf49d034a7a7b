"""The port's own copies of the framework-free parts, and its import rule.

- the G2P / symbol copy gives ids identical to ``viet_tts_tpu.text``;
- ``viet_tts_torch.config`` equals the YAML it was copied from;
- no module of ``viet_tts_torch`` and not ``chip_smoke.py`` imports JAX,
  flax or the JAX package (an AST scan);
- the entry points refuse to run without a card unless asked for the CPU.
"""

import ast
import os
import pathlib

import numpy as np
import pytest
import yaml

import viet_tts_tpu.text as jax_text
from viet_tts_tpu.data.batching import DEFAULT_TEXT_BUCKETS as JAX_BUCKETS
from viet_tts_tpu.data.batching import bucket_for as jax_bucket_for
from viet_tts_torch import config as port_config
from viet_tts_torch import text as port_text
from viet_tts_torch.data.batching import DEFAULT_TEXT_BUCKETS, bucket_for
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent

SENTENCES = [
    "Hôm nay trời đẹp quá!",
    "Người Việt Nam rất hiếu khách và thân thiện.",
    "Chúng tôi đã đi Hà Nội vào năm hai nghìn không trăm hai mươi ba.",
    "Thành phố Hồ Chí Minh là trung tâm kinh tế lớn nhất cả nước.",
    "Xin chào các bạn.",
    "Bạn có khỏe không?",
    "Cà phê sữa đá là thức uống quen thuộc.",
    "Tàu hỏa chạy từ Bắc vào Nam.",
]
# the G2P has no entry for some word-final diphthongs before punctuation;
# the copy must fail on them exactly as the JAX package does
UNMAPPED = ["Trường học ở gần nhà tôi.", "Giáo dục là chìa khóa của tương lai."]


def test_g2p_ids_match_jax_package():
    g_port, g_jax = port_text.VietnameseG2P(), jax_text.VietnameseG2P()
    assert port_text.SYMBOLS == jax_text.SYMBOLS
    for s in SENTENCES:
        phones_p = g_port(port_text.basic_clean(s), get_boundary=False)
        phones_j = g_jax(jax_text.basic_clean(s), get_boundary=False)
        assert phones_p == phones_j
        assert port_text.symbols_to_ids(phones_p) == jax_text.symbols_to_ids(phones_j)
    for s in UNMAPPED:
        with pytest.raises(KeyError) as err_p:
            g_port(port_text.basic_clean(s), get_boundary=False)
        with pytest.raises(KeyError) as err_j:
            g_jax(jax_text.basic_clean(s), get_boundary=False)
        assert err_p.value.args == err_j.value.args


def test_buckets_match_jax_package():
    assert DEFAULT_TEXT_BUCKETS == JAX_BUCKETS
    for n in (1, 32, 33, 200, 1000):
        assert bucket_for(n, DEFAULT_TEXT_BUCKETS) == jax_bucket_for(n, JAX_BUCKETS)


def test_split_sentences_matches_jax_package():
    from viet_tts_tpu.infer.api import split_sentences as jax_split
    from viet_tts_torch.infer.api import split_sentences

    words = " ".join(f"từ{i}," if i % 7 == 6 else f"từ{i}" for i in range(50))
    text = " ".join(SENTENCES) + " " + words + ". Hết… Xong; thật"
    for max_words in (40, 9, 4):
        got = split_sentences(text, max_words=max_words)
        assert got == jax_split(text, max_words=max_words)
        assert all(len(s.split()) <= max_words for s in got)
    assert split_sentences("  ") == []


def test_config_dicts_equal_yaml():
    with open(REPO / "config" / "model_config.yaml", encoding="utf8") as f:
        models = yaml.safe_load(f)
    with open(REPO / "config" / "preprocessing_config.yaml", encoding="utf8") as f:
        audio = yaml.safe_load(f)
    with open(REPO / "config" / "train_config.yaml", encoding="utf8") as f:
        train = yaml.safe_load(f)
    assert port_config.jets_generator_params() == models["jets"]["generator_params"]
    assert port_config.jets_discriminator_params() == models["jets"]["discriminator_params"]
    assert port_config.jets_train_conf() == train["jets"]
    assert port_config.fastspeech2_train_conf() == train["fastspeech2"]
    assert port_config.matcha_train_conf() == train["matcha"]
    assert port_config.GRAD_CLIP_THRESH == train["grad_clip_thresh"]
    assert port_config.default_audio() == audio
    assert port_config.upsample_factor(audio) == 256


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(encoding="utf8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "viet_tts_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "optax", "viet_tts_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_entry_points_need_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    import torch

    from viet_tts_torch.device import resolve_device
    from viet_tts_torch.infer.api import OneStageTTS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        OneStageTTS(str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")
    assert os.path.isdir(REPO / "viet_tts_torch" / "csrc")
    assert np.all([p.suffix in (".cu", ".cuh")
                   for p in (REPO / "viet_tts_torch" / "csrc").iterdir()])
