"""The port's own copies of the JAX package's host modules (config,
registry, tokenizer, processor, stop criteria) against the originals: the
same inputs must give the same outputs, field by field."""

import dataclasses
import json

import numpy as np
import pytest

from phi_3_vision_mlx_tpu.core import config as JC
from phi_3_vision_mlx_tpu.core import registry as JR
from phi_3_vision_mlx_tpu.core import weights as JW
from phi_3_vision_mlx_tpu.engine import stream as JST
from phi_3_vision_mlx_tpu.models import preprocess as JP
from phi_3_vision_mlx_tpu.models import tokenizer as JT

pytest.importorskip("torch")

from phi_3_vision_mlx_tpu_torch.core import config as TC  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import registry as TR  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import stream as TST  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import preprocess as TP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import tokenizer as TT  # noqa: E402

TEXTS = ["Hello there", "<|user|>\nA lighthouse keeper's log.<|end|>\n<|assistant|>\n",
         "ünïcödé and emoji \U0001F600", ""]


def _fields(obj):
    """A config as nested plain values (class names dropped: each package
    has its own classes)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


@pytest.mark.parametrize("name", ["phi35_mini", "phi35_vision", "tiny", "tiny_vision"])
def test_presets_match_field_by_field(name):
    want, got = JC.preset(name), TC.preset(name)
    assert _fields(got) == _fields(want)
    assert (got.head_dim, got.has_vision) == (want.head_dim, want.has_vision)
    over = dict(hidden_size=192, num_attention_heads=2, num_key_value_heads=1, dtype="bfloat16")
    assert _fields(TC.preset(name, **over)) == _fields(JC.preset(name, **over))
    with pytest.raises(KeyError):
        TC.preset("nope")


def test_config_from_dict_on_a_saved_config_json(tmp_path):
    """A checkpoint written by the JAX package, quantized: its config.json
    through both ``config_from_dict``, with and without overrides."""
    raw_dir, q_dir = str(tmp_path / "raw"), str(tmp_path / "q")
    JW.create_random_checkpoint(raw_dir, "tiny", vocab_size=32064)
    JW.quantize_checkpoint(raw_dir, q_dir)
    for d in (raw_dir, q_dir):
        raw = json.load(open(f"{d}/config.json"))
        assert _fields(TC.config_from_dict(raw)) == _fields(JC.config_from_dict(raw))
        over = dict(use_quantized_cache=True, dtype_override="bfloat16")
        assert _fields(TC.config_from_dict(raw, **over)) == _fields(JC.config_from_dict(raw, **over))
    vision = JC.config_to_dict(JC.preset("tiny_vision"))
    assert _fields(TC.config_from_dict(vision)) == _fields(JC.config_from_dict(vision))
    assert TC.ID_EOS == JC.ID_EOS


@pytest.mark.parametrize("bits", [None, 4, 8])
@pytest.mark.parametrize("name", ["phi35_mini", "phi35_vision", "tiny", "tiny_vision"])
def test_config_to_dict_matches(name, bits):
    """The dict a checkpoint's config.json holds, from each package's
    ``config_to_dict``, and back through the port's ``config_from_dict``."""
    want, got = JC.preset(name), TC.preset(name)
    if bits:
        want, got = want.replace(quantized=JC.QuantConfig(64, bits)), got.replace(
            quantized=TC.QuantConfig(64, bits))
    d = TC.config_to_dict(got)
    assert d == JC.config_to_dict(want)
    assert _fields(TC.config_from_dict(json.loads(json.dumps(d)))) == _fields(got)


def test_registry_matches():
    assert TR.processor_for("Phi3ForCausalLM") is TP.Phi3Processor
    assert TR.processor_for("Phi3VForCausalLM") is TP.Phi3VProcessor
    for arch in ("Phi3ForCausalLM", "Phi3VForCausalLM", "Phi3ForConditionalGeneration"):
        assert TR.processor_for(arch).__name__ == JR.processor_for(arch).__name__
    with pytest.raises(KeyError):
        TR.processor_for("LlamaForCausalLM")
    vproc = TP.Phi3VProcessor(tokenizer=TT.ByteTokenizer())
    assert vproc.img_processor.num_crops == 16
    assert vproc("text only")["input_ids"].tolist() == TP.Phi3Processor(tokenizer=TT.ByteTokenizer())(
        "text only")["input_ids"].tolist()


def test_tokenizer_round_trips_match(tmp_path):
    jt, tt = JT.ByteTokenizer(), TT.ByteTokenizer()
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert tt.encode(text, add_special_tokens=False) == jt.encode(text, add_special_tokens=False)
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.decode(ids, skip_special_tokens=True) == jt.decode(ids, skip_special_tokens=True)
    odd = [0, 1, 32007, 31999, 1065, 99999]
    assert tt.decode(odd) == jt.decode(odd)
    assert tt(TEXTS).input_ids == jt(TEXTS).input_ids
    assert tt.batch_decode([[1065, 32007], [1066]]) == jt.batch_decode([[1065, 32007], [1066]])
    assert (tt.vocab_size, tt.eos_token_id, tt.bos_token_id, tt.pad_token_id) == (
        jt.vocab_size, jt.eos_token_id, jt.bos_token_id, jt.pad_token_id)
    assert type(TT.load_tokenizer(str(tmp_path))) is TT.ByteTokenizer


def test_processor_outputs_match():
    jp, tp = JP.Phi3Processor(tokenizer=JT.ByteTokenizer()), TP.Phi3Processor(tokenizer=TT.ByteTokenizer())
    one_j, one_t = jp(TEXTS[1]), tp(TEXTS[1])
    assert one_t.keys() == one_j.keys()
    np.testing.assert_array_equal(one_t["input_ids"], one_j["input_ids"])
    batch = TEXTS[:3]  # three prompts of different lengths: left-padded
    bj, bt = jp(batch), tp(batch)
    assert bt.keys() == bj.keys() == {"input_ids", "pids", "mask"}
    for key in bj:
        assert bt[key].dtype == bj[key].dtype
        np.testing.assert_array_equal(bt[key], bj[key])
    assert bt["mask"][:, 0].tolist() == [0, 1, 0]


def test_stoppers_match():
    """LogitStopper, TokenStopper and StopSequences over one fixed token and
    log-prob sequence, step by step."""
    rng = np.random.default_rng(0)
    steps = 40
    best = -np.abs(rng.standard_normal(steps)) * 0.5
    eos = np.linspace(-9.0, -0.2, steps) + rng.standard_normal(steps) * 0.3
    for early in (False, 5, 30, 100):
        j, t = JST.LogitStopper(steps, early), TST.LogitStopper(steps, early)
        for i in range(steps):
            assert t.update(best[i], eos[i], 1) == j.update(best[i], eos[i], 1), (early, i)
        assert t.update(0.0, 0.0, 2) == j.update(0.0, 0.0, 2)
    toks = rng.integers(1000, 1256, (steps, 3))
    toks[10, 0], toks[25, 1], toks[33:, 2] = 32007, 32007, 32007
    j, t = JST.TokenStopper(3), TST.TokenStopper(3)
    assert [t.update(x) for x in toks] == [j.update(x) for x in toks]
    tok = JT.ByteTokenizer()
    stops = ["ab", "<|end|>", "zz"]
    j, t = JST.StopSequences(tok, stops, 3), TST.StopSequences(TT.ByteTokenizer(), stops, 3)
    text_toks = np.array([[1097, 1098, 1000 + ord("z")]] * 4 + [[1000 + ord("a"), 32007, 1122]] * 4)
    assert [t.update(x) for x in text_toks] == [j.update(x) for x in text_toks]
    assert t.hit.tolist() == j.hit.tolist()
    assert t.trim(["xxabyy", "no stop"]) == j.trim(["xxabyy", "no stop"])
    for stop in (None, "x", ["a", "b"], "", [""], 3, ["a"] * 17):
        try:
            want = JST.validate_stops(stop)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                TST.validate_stops(stop)
        else:
            assert TST.validate_stops(stop) == want
    assert TST.stop_tail_window(stops) == JST.stop_tail_window(stops)


def test_streamer_matches(capsys):
    tok_ids = np.array([[1000 + b] for b in b"Hello brave new world, hi"])
    outs = []
    for mod, tk in ((JST, JT), (TST, TT)):
        s = mod.Streamer(tk.ByteTokenizer(), stream=True, mute=False, stops=["hi"])
        for t in tok_ids:
            s(t[None])
        outs.append((s.end(), capsys.readouterr().out))
        b = mod.Streamer(tk.ByteTokenizer(), stream=False, mute=True)
        for t in np.concatenate([tok_ids[:5], [[32007]], tok_ids[5:8]]):
            b(np.array([t, t + 1]))
        outs.append(b.end())
    assert outs[0] == outs[2] and outs[1] == outs[3]
