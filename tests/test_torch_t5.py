"""The port's umT5 encoder (wanq_tpu_torch/models/t5.py) and tokenizer
wrapper against wanq_tpu's on the CPU, on the same weights from one
``init_t5_params`` seed.

Tolerances: float32 ``encoder_forward`` with a ragged mask and
``t5_model_forward`` rel-L2 <= 1e-5 (each linear is an f32 product in both,
summed in another order); the relative-position buckets, the init draw, the
state-dict converter and the tokenizer wrapper equal.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wanq_tpu.models import t5 as jt5
from wanq_tpu.models import tokenizers as jtok
from wanq_tpu_torch.configs import WAN_CONFIGS, tiny_config
from wanq_tpu_torch.models import t5 as tt5
from wanq_tpu_torch.models import tokenizers as ttok


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for the port's CPU ops: the test runs share the
    host's cores among several worker processes, and one torch thread per
    core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: v for k, sub in tree.items()
                for p, v in _leaves(sub).items()}
    if isinstance(tree, list):
        return {f"{i}.{p}" if p else str(i): v for i, sub in enumerate(tree)
                for p, v in _leaves(sub).items()}
    return {"": tree}


def _ids_mask(rng, b=2, length=20, valid=(13, 7), vocab=128):
    ids = rng.integers(0, vocab, (b, length))
    mask = np.zeros((b, length), np.int64)
    for i, n in enumerate(valid):
        mask[i, :n] = 1
    return ids, mask


def _reference_state_dict(params):
    """Port encoder params -> the reference checkpoint's state dict."""
    sd = {"token_embedding.weight": params["token_embedding"],
          "norm.weight": params["norm"]["w"]}
    for i, bp in enumerate(params["blocks"]):
        for leaf in ("q", "k", "v", "o"):
            sd[f"blocks.{i}.attn.{leaf}.weight"] = bp["attn"][leaf]["w"].t().contiguous()
        sd[f"blocks.{i}.norm1.weight"] = bp["norm1"]["w"]
        sd[f"blocks.{i}.norm2.weight"] = bp["norm2"]["w"]
        sd[f"blocks.{i}.ffn.gate.0.weight"] = bp["ffn"]["gate"]["0"]["w"].t().contiguous()
        sd[f"blocks.{i}.ffn.fc1.weight"] = bp["ffn"]["fc1"]["w"].t().contiguous()
        sd[f"blocks.{i}.ffn.fc2.weight"] = bp["ffn"]["fc2"]["w"].t().contiguous()
        sd[f"blocks.{i}.pos_embedding.embedding.weight"] = bp["pos_embedding"]["embedding"]
    return sd


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets", [8, 32])
def test_relative_position_bucket_equals_jax(bidirectional, num_buckets):
    rel = np.arange(-300, 300)[None, :] - np.arange(0, 40)[:, None]
    np.testing.assert_array_equal(
        tt5.relative_position_bucket(rel, num_buckets, bidirectional),
        jt5.relative_position_bucket(rel, num_buckets, bidirectional))


@pytest.mark.parametrize("encoder_only", [True, False], ids=["encoder", "full_model"])
def test_init_t5_params_equal_jax(encoder_only):
    cfg_j, cfg_t = jt5.tiny_t5_config(), tt5.tiny_t5_config()
    pj = _leaves(jax.tree.map(np.asarray, jt5.init_t5_params(cfg_j, 5, encoder_only)))
    pt = _leaves(tt5.init_t5_params(cfg_t, 5, encoder_only, device="cpu"))
    assert sorted(pj) == sorted(pt)
    for k in pj:
        np.testing.assert_array_equal(pj[k], pt[k].numpy(), err_msg=k)


def test_encoder_forward_ragged_mask_matches_jax(rng):
    cfg_j, cfg_t = jt5.tiny_t5_config(), tt5.tiny_t5_config()
    pj, pt = jt5.init_t5_params(cfg_j, 3), tt5.init_t5_params(cfg_t, 3, device="cpu")
    ids, mask = _ids_mask(rng)
    want = np.asarray(jt5.encoder_forward(pj, cfg_j, jnp.asarray(ids), jnp.asarray(mask)))
    got = tt5.encoder_forward(pt, cfg_t, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 20, 32)
    assert _rel(want, got.numpy()) <= 1e-5


def test_t5_model_forward_matches_jax_and_decoder_is_causal(rng):
    cfg_j, cfg_t = jt5.tiny_t5_config(), tt5.tiny_t5_config()
    pj = jt5.init_t5_params(cfg_j, 4, encoder_only=False)
    pt = tt5.init_t5_params(cfg_t, 4, encoder_only=False, device="cpu")
    ids, mask = _ids_mask(rng)
    dec = rng.integers(0, 128, (2, 9))
    want = np.asarray(jt5.t5_model_forward(pj, cfg_j, jnp.asarray(ids), jnp.asarray(mask),
                                           jnp.asarray(dec)))
    got = tt5.t5_model_forward(pt, cfg_t, torch.from_numpy(ids), torch.from_numpy(mask),
                               torch.from_numpy(dec))
    assert tuple(got.shape) == want.shape == (2, 9, 128)
    assert _rel(want, got.numpy()) <= 1e-5
    # a later decoder token changes nothing before it
    dec2 = dec.copy()
    dec2[:, 6:] = (dec2[:, 6:] + 1) % 128
    got2 = tt5.t5_model_forward(pt, cfg_t, torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(dec2))
    assert torch.equal(got[:, :6], got2[:, :6])
    assert not torch.equal(got[:, 6:], got2[:, 6:])


def test_convert_t5_state_dict_matches_jax(rng):
    """A reference-layout state dict (bf16 linears, as the published
    checkpoint) converts to the params it came from, and both packages'
    converters give encoders that agree."""
    cfg_t = tt5.tiny_t5_config(param_dtype="bfloat16")
    cfg_j = jt5.tiny_t5_config(param_dtype="bfloat16")
    pt = tt5.init_t5_params(cfg_t, 6, device="cpu")
    sd = _reference_state_dict(pt)
    conv = tt5.convert_t5_state_dict(sd, dtype=torch.bfloat16, device="cpu")
    a, b = _leaves(pt), _leaves(conv)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    ids, mask = _ids_mask(rng)
    want = np.asarray(jt5.encoder_forward(jt5.convert_t5_state_dict(sd, dtype=jnp.bfloat16),
                                          cfg_j, jnp.asarray(ids), jnp.asarray(mask)))
    got = tt5.encoder_forward(conv, cfg_t, torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(want, got.numpy()) <= 2e-3  # bf16 products, rounded at other sites
    with pytest.raises(KeyError, match="unexpected T5 key"):
        tt5.convert_t5_state_dict({"shared.weight": sd["norm.weight"]}, device="cpu")


class _StubTokenizer:
    """Fixed ids for any text: the first ``valid[i]`` positions of row i."""

    def __init__(self, ids, mask):
        self.ids, self.mask, self.calls = ids, mask, []

    def __call__(self, texts, return_mask=False, add_special_tokens=True):
        self.calls.append(list(texts))
        return self.ids[:len(texts)], self.mask[:len(texts)]


def test_encoder_model_zeroes_the_padding(rng, tmp_path):
    """T5EncoderModel (checkpoint from a test-written .pth, a stub tokenizer):
    the states are wanq_tpu's encoder_forward x mask, zero past each
    prompt's length; encode_ids gives the same without text."""
    cfg = tt5.tiny_t5_config()
    pt = tt5.init_t5_params(cfg, 7, device="cpu")
    torch.save(_reference_state_dict(pt), tmp_path / "t5.pth")
    enc = tt5.T5EncoderModel(20, checkpoint_path=str(tmp_path / "t5.pth"), cfg=cfg,
                             device="cpu")
    ids, mask = _ids_mask(rng)
    enc.tokenizer = _StubTokenizer(ids, mask)
    got = enc(["a red fox", "a blue whale"])
    assert enc.tokenizer.calls == [["a red fox", "a blue whale"]]
    assert torch.equal(got, enc.encode_ids(ids, mask))
    assert float(got[0, 13:].abs().max()) == 0.0 and float(got[1, 7:].abs().max()) == 0.0
    cfg_j = jt5.tiny_t5_config()
    want = np.asarray(jt5.encoder_forward(jt5.init_t5_params(cfg_j, 7), cfg_j,
                                          jnp.asarray(ids), jnp.asarray(mask))) * mask[..., None]
    assert _rel(want, got.numpy()) <= 1e-5


def test_encode_prompts_builds_the_tokenizer_lazily(rng, tmp_path, monkeypatch):
    """encode_prompts from a checkpoint dir: the wrapper tokenizer is built
    on the first call with text, from the config's tokenizer path, with
    whitespace cleaning; --t5_cpu keeps the encoder on the host."""
    cfg = tt5.tiny_t5_config()
    wan = tiny_config()
    ids, mask = _ids_mask(rng, length=wan.text_len, valid=(5, 9))
    built = []

    class Tok(_StubTokenizer):
        def __init__(self, name, seq_len=None, clean=None):
            built.append((name, seq_len, clean))
            super().__init__(ids, mask)

    class Tiny(tt5.T5EncoderModel):  # the tiny encoder in place of umT5-XXL
        def __init__(self, *a, **kw):
            super().__init__(*a, cfg=cfg, **kw)
            assert self.device.type == "cpu"

    monkeypatch.setattr(ttok, "HuggingfaceTokenizer", Tok)
    monkeypatch.setattr(tt5, "T5EncoderModel", Tiny)
    torch.save(_reference_state_dict(tt5.init_t5_params(cfg, 8, device="cpu")),
               tmp_path / wan.t5_checkpoint)
    ctx, ctx_null = tt5.encode_prompts(str(tmp_path), wan, ["a red fox"], ["blurry"],
                                       on_cpu=True)
    assert built == [(wan.t5_tokenizer, wan.text_len, "whitespace")]
    assert ctx.shape == ctx_null.shape == (1, wan.text_len, cfg.dim)
    assert np.array_equal(ctx, ctx_null)  # the stub gives both the same ids
    assert np.abs(ctx[0, 5:]).max() == 0.0 and np.abs(ctx[0, :5]).max() > 0.0


def test_init_t5_params_on_device_on_the_cpu():
    """The on-device draw (a torch.Generator; umT5-XXL on the card) has
    init_t5_params' tree, shapes and dtypes, is one draw per seed, and its
    linears have the stds of the reference's init."""
    cfg = tt5.tiny_t5_config(param_dtype="bfloat16", dim=64, dim_attn=64, dim_ffn=256)
    a = _leaves(tt5.init_t5_params_on_device(cfg, 1, device="cpu"))
    b = _leaves(tt5.init_t5_params_on_device(cfg, 1, device="cpu"))
    ref = _leaves(tt5.init_t5_params(cfg, 1, device="cpu"))
    assert sorted(a) == sorted(ref)
    for k in ref:
        assert a[k].shape == ref[k].shape and a[k].dtype == ref[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["token_embedding"],
                           tt5.init_t5_params_on_device(cfg, 2, device="cpu")["token_embedding"])
    for k, std in (("blocks.0.ffn.fc1.w", cfg.dim ** -0.5),
                   ("blocks.1.ffn.fc2.w", cfg.dim_ffn ** -0.5),
                   ("token_embedding", 1.0)):
        s = float(a[k].float().std())
        assert abs(s / std - 1) <= 4 * (2 / a[k].numel()) ** 0.5 + 0.01, (k, s, std)
    assert all(torch.equal(a[k], torch.ones_like(a[k])) for k in a if k.endswith("norm1.w"))


def _fake_transformers(monkeypatch):
    """A ``transformers`` module whose AutoTokenizer maps words to ids by a
    fixed table: both packages' wrappers run on it."""
    seen = []

    class Fast:
        vocab_size = 16

        def __call__(self, seqs, return_tensors, padding=None, truncation=None,
                     max_length=None, add_special_tokens=True):
            seen.append((list(seqs), return_tensors, padding, truncation, max_length))
            rows = [[hash(w) % 13 + 3 for w in s.split()] + [1] * add_special_tokens
                    for s in seqs]
            rows = [r[:max_length] + [0] * (max_length - len(r[:max_length])) for r in rows]
            ids = np.asarray(rows)
            return types.SimpleNamespace(input_ids=ids, attention_mask=(ids != 0).astype(int))

    class Auto:
        @staticmethod
        def from_pretrained(name, **kw):
            return Fast()

    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(AutoTokenizer=Auto))
    return seen


@pytest.mark.parametrize("clean", [None, "whitespace", "lower", "canonicalize"])
def test_tokenizer_wrapper_equals_jax(monkeypatch, clean):
    seen = _fake_transformers(monkeypatch)
    texts = ["  A  red_Fox,\n jumps &amp; runs  ", "a blue whale"]
    got = ttok.HuggingfaceTokenizer("stub", seq_len=6, clean=clean)(
        texts, return_mask=True, add_special_tokens=True)
    want = jtok.HuggingfaceTokenizer("stub", seq_len=6, clean=clean)(
        texts, return_mask=True, add_special_tokens=True)
    assert seen[0] == seen[1] and seen[0][1:] == ("np", "max_length", True, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ttok.canonicalize(texts[0]) == jtok.canonicalize(texts[0])
    assert ttok.canonicalize("a.b-c", "-") == jtok.canonicalize("a.b-c", "-")
    with pytest.raises(ValueError, match="clean mode"):
        ttok.HuggingfaceTokenizer("stub", clean="upper")


def test_t5_config_is_umt5_xxl():
    cfg = tt5.UMT5_XXL
    assert (cfg.vocab_size, cfg.dim, cfg.dim_ffn, cfg.num_heads, cfg.num_layers) == (
        256384, 4096, 10240, 64, 24)
    assert cfg.dtype == torch.bfloat16 and cfg.head_dim == 64
    assert WAN_CONFIGS["t2v-1.3B"].text_dim == cfg.dim
