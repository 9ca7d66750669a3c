"""The port's vision path against the JAX package on the ``tiny_vision``
preset in float32: the CLIP tower, the image embedding, both device image
pipelines, the image processor's three modes, the prompt merge, and
``api.generate(images=...)`` end to end from one checkpoint the JAX package
wrote (unquantized and 4-bit; dense and int4 cache; one and two images).

The image processor runs with ``num_crops=4``, as tests/test_vision.py does,
so an image is at most a 2 x 2 grid of crops.  The 4-bit checkpoint's scales
and biases are rounded to bf16-representable values first (the port stores
them as bf16; tests/test_torch_model.py:make_checkpoint explains), and the
int4-cache runs replay the JAX package's quantized entries
(tests/test_torch_model.py:ReplayJaxCache).
"""

import copy
import glob
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

import reference_numpy as ref  # noqa: E402
from test_torch_model import VOCAB, ReplayJaxCache, _jax_decode  # noqa: E402

from phi_3_vision_mlx_tpu import api as JAPI  # noqa: E402
from phi_3_vision_mlx_tpu.core import weights as JW  # noqa: E402
from phi_3_vision_mlx_tpu.core.config import preset as jax_preset  # noqa: E402
from phi_3_vision_mlx_tpu.engine import engine as JE  # noqa: E402
from phi_3_vision_mlx_tpu.models import phi3 as JM  # noqa: E402
from phi_3_vision_mlx_tpu.models import vision as JV  # noqa: E402
from phi_3_vision_mlx_tpu.models.image_processor import Phi3VImageProcessor as JIP  # noqa: E402
from phi_3_vision_mlx_tpu_torch import api as TAPI  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core import weights as TW  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.config import preset  # noqa: E402
from phi_3_vision_mlx_tpu_torch.core.convert import from_numpy_params  # noqa: E402
from phi_3_vision_mlx_tpu_torch.engine import engine as TE  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import phi3 as TM  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models import vision as TV  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models.image_processor import Phi3VImageProcessor as TIP  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3VProcessor  # noqa: E402
from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from phi_3_vision_mlx_tpu_torch.utils.media import ArrayImage, fetch_image  # noqa: E402

CLIP_TOL = 2e-4  # the tower: f32 sums in another order through the layers
FEATURE_TOL = 3e-4  # the image features: the tower, then pooling and projection
PIXEL_TOL = 1e-5  # pixel_values: the same numpy arithmetic, a float32 bicubic
LOGIT_REL_L2 = 1e-4
# (height, width) of the test images: landscape and portrait (the portrait
# path transposes before and after the resize).
SHAPES = {"landscape": (75, 125), "portrait": (130, 90)}


def image(shape, seed=0):
    h, w = shape
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t2n(t):
    return t.detach().float().numpy()


# --- the tower and the image embedding ---------------------------------------


@pytest.fixture(scope="module")
def params():
    """(cfg, JAX params, the port's params) of one random ``tiny_vision``
    model (the JAX ``init_params``), with non-zero separators."""
    cfg = jax_preset("tiny_vision", vocab_size=VOCAB)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    v = jp["model"]["vision_embed_tokens"]
    rng = np.random.default_rng(1)
    v["sub_GN"] = jnp.asarray(rng.normal(size=v["sub_GN"].shape).astype(np.float32))
    v["glb_GN"] = jnp.asarray(rng.normal(size=v["glb_GN"].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = preset("tiny_vision", vocab_size=VOCAB)
    return tcfg, jp, from_numpy_params(tree, tcfg)


def _numpy_clip_weights(vm):
    """The JAX tree's CLIP tower in reference_numpy.clip_tower's names
    ((out, in) linears, as the reference stores them)."""
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    lay = vm["encoder"]["layers"]
    layers = []
    for i in range(lay["layer_norm1"]["weight"].shape[0]):
        att, mlp = lay["self_attn"], lay["mlp"]
        layers.append({
            "ln1_w": f(lay["layer_norm1"]["weight"][i]), "ln1_b": f(lay["layer_norm1"]["bias"][i]),
            "ln2_w": f(lay["layer_norm2"]["weight"][i]), "ln2_b": f(lay["layer_norm2"]["bias"][i]),
            **{f"{n}_w": f(att[f"{n}_proj"]["weight"][i]).T for n in ("q", "k", "v", "out")},
            **{f"{n}_b": f(att[f"{n}_proj"]["bias"][i]) for n in ("q", "k", "v", "out")},
            "fc1_w": f(mlp["fc1"]["weight"][i]).T, "fc1_b": f(mlp["fc1"]["bias"][i]),
            "fc2_w": f(mlp["fc2"]["weight"][i]).T, "fc2_b": f(mlp["fc2"]["bias"][i]),
        })
    emb = vm["embeddings"]
    return {"patch_w": f(emb["patch_embedding"]["weight"]), "class_emb": f(emb["class_embedding"]),
            "pos_emb": f(emb["position_embedding"]["weight"]), "pre_ln_w": f(vm["pre_layrnorm"]["weight"]),
            "pre_ln_b": f(vm["pre_layrnorm"]["bias"]), "layers": layers}


def test_clip_tower_matches_jax_and_numpy(params):
    """Two crops through the tower (penultimate layer, CLS dropped) against
    the JAX ``clip_vision_forward`` and the numpy transcription of the
    reference."""
    cfg, jp, tp = params
    vc = cfg.vision
    pixels = np.random.default_rng(2).normal(size=(2, 336, 336, 3)).astype(np.float32)
    got = t2n(TV.clip_vision_forward(tp["model"]["vision_embed_tokens"], vc, torch.from_numpy(pixels)))
    want = np.asarray(JV.clip_vision_forward(jp["model"]["vision_embed_tokens"], jax_preset(
        "tiny_vision").vision, jnp.asarray(pixels)))
    vcfg = {"patch_size": vc.patch_size, "hidden_size": vc.hidden_size,
            "num_attention_heads": vc.num_attention_heads, "layer_norm_eps": vc.layer_norm_eps}
    numpy_ref = ref.clip_tower(vcfg, _numpy_clip_weights(
        jax.tree_util.tree_map(np.asarray, jp["model"]["vision_embed_tokens"]["img_processor"]["vision_model"])),
        pixels.transpose(0, 3, 1, 2))
    assert got.shape == want.shape == (2, 576, vc.hidden_size)
    np.testing.assert_allclose(got, want, rtol=CLIP_TOL, atol=CLIP_TOL)
    np.testing.assert_allclose(got, numpy_ref, rtol=CLIP_TOL, atol=CLIP_TOL)


def test_penultimate_layer_is_the_output(params):
    """All layers but the last run: the last layer's weights do not reach
    the features, the first layer's do."""
    cfg, _, tp = params
    v = copy.deepcopy(tp["model"]["vision_embed_tokens"])
    pixels = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 336, 336, 3)).astype(np.float32))
    before = TV.clip_vision_forward(v, cfg.vision, pixels)
    fc2 = v["img_processor"]["vision_model"]["encoder"]["layers"]["mlp"]["fc2"]["weight"]
    fc2[-1] = 7.0
    assert torch.equal(TV.clip_vision_forward(v, cfg.vision, pixels), before)
    fc2[0] = 7.0
    assert not torch.equal(TV.clip_vision_forward(v, cfg.vision, pixels), before)


@pytest.mark.parametrize("grid", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
def test_compute_image_embeds_matches_jax(params, grid):
    """17 normalized crops of an image of ``grid`` crops -> pooled,
    separated, projected features (non-zero ``sub_GN``/``glb_GN``), and the
    token count ``(gh gw + 1) 144 + 1 + (gh + 1) 12``."""
    cfg, jp, tp = params
    gh, gw = grid
    pv = np.random.default_rng(4).normal(size=(1, 17, 3, 336, 336)).astype(np.float32)
    sizes = np.array([[336 * gh, 336 * gw]])
    (got,) = TV.compute_image_embeds(tp, cfg, pv, sizes)
    (want,) = JV.compute_image_embeds(jp, jax_preset("tiny_vision", vocab_size=VOCAB), pv, sizes)
    assert got.shape == want.shape == (1, (gh * gw + 1) * 144 + 1 + (gh + 1) * 12, cfg.hidden_size)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=FEATURE_TOL, atol=FEATURE_TOL)


def test_compute_inputs_embeds_matches_jax(params, monkeypatch):
    """The text embeddings with the features written over the placeholders
    (``pixel_values`` mode, ``PHI3V_TPU_DEVICE_IMAGE=0``)."""
    cfg, jp, tp = params
    proc = Phi3VProcessor(tokenizer=ByteTokenizer())
    proc.img_processor = TIP(num_crops=4)
    monkeypatch.setenv("PHI3V_TPU_DEVICE_IMAGE", "0")
    d = proc("<|image_1|>\nWhat is it?", images=[image(SHAPES["landscape"])])
    assert "pixel_values" in d
    got = t2n(TV.compute_inputs_embeds(tp, cfg, d))
    want = np.asarray(JV.compute_inputs_embeds(jp, jax_preset("tiny_vision", vocab_size=VOCAB), d))
    np.testing.assert_allclose(got, want, rtol=FEATURE_TOL, atol=FEATURE_TOL)


@pytest.mark.parametrize("orient", list(SHAPES))
def test_device_image_features_match_jax(params, orient):
    """Both device pipelines from uint8 pixels: the raw one (PIL's bilinear
    resize as products, white padding, the portrait transposes) and the
    hd one (from PIL's host resize)."""
    cfg, jp, tp = params
    jcfg = jax_preset("tiny_vision", vocab_size=VOCAB)
    v, jv = tp["model"]["vision_embed_tokens"], jp["model"]["vision_embed_tokens"]
    img = image(SHAPES[orient], seed=5)
    proc = TIP(num_crops=4)
    plan = proc.resize_plan(img)
    assert plan["trans"] == (orient == "portrait")
    gh, gw = plan["out_h"] // 336, plan["out_w"] // 336
    raw = np.asarray(img, np.uint8)
    got = TV.device_image_features_raw(v, cfg.vision, torch.from_numpy(raw.copy()), plan, gh, gw)
    want = JV.device_image_features_raw(jv, jcfg.vision, jcfg.image_dim_out, jnp.asarray(raw), plan, gh, gw)
    assert got.shape[1] == TIP.count_tokens(plan["out_h"], plan["out_w"])
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=FEATURE_TOL, atol=FEATURE_TOL)
    hd = proc.hd_transform_uint8(img)
    assert hd.shape[:2] == (plan["out_h"], plan["out_w"])
    got = TV.device_image_features(v, cfg.vision, torch.from_numpy(hd.copy()), gh, gw)
    want = JV.device_image_features(jv, jcfg.vision, jcfg.image_dim_out, jnp.asarray(hd), gh, gw)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=FEATURE_TOL, atol=FEATURE_TOL)


# --- the image processor and the prompt merge -------------------------------


@pytest.mark.parametrize("orient", list(SHAPES))
@pytest.mark.parametrize("mode", ["raw", "hd", "pixel_values"])
def test_image_processor_modes_match_jax(orient, mode, monkeypatch):
    """Each mode of ``__call__`` (raw by default, hd with
    ``PHI3V_TPU_HOST_RESIZE=1``, ``pixel_values`` with ``raw=False``) on
    the same PIL image: equal plans, sizes and token counts, equal pixels."""
    if mode == "hd":
        monkeypatch.setenv("PHI3V_TPU_HOST_RESIZE", "1")
    imgs = [image(SHAPES[orient], seed=6)]
    raw = mode != "pixel_values"
    got, want = TIP(num_crops=4)(imgs, raw=raw), JIP(num_crops=4)(imgs, raw=raw)
    assert got.keys() == want.keys()
    assert got["image_sizes"] == want["image_sizes"] and got["num_img_tokens"] == want["num_img_tokens"]
    if mode == "raw":
        assert got["resize_plans"] == want["resize_plans"]
        np.testing.assert_array_equal(got["raw_images"][0], want["raw_images"][0])
    elif mode == "hd":
        np.testing.assert_array_equal(got["hd_images"][0], want["hd_images"][0])
    else:
        np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], rtol=0, atol=PIXEL_TOL)


def test_raw_mode_needs_no_pil():
    """The raw mode reads ``.size`` and ``.convert("RGB")`` alone, so a
    numpy-backed image gives what the PIL image of the same pixels gives;
    ``fetch_image`` passes it through untouched."""
    pixels = np.asarray(image(SHAPES["portrait"], seed=7))
    duck = ArrayImage(pixels)
    assert fetch_image(duck) is duck
    got, want = TIP(num_crops=4)([duck], raw=True), TIP(num_crops=4)([Image.fromarray(pixels)], raw=True)
    assert got["resize_plans"] == want["resize_plans"] and got["image_sizes"] == want["image_sizes"]
    np.testing.assert_array_equal(got["raw_images"][0], want["raw_images"][0])


@pytest.mark.parametrize("n_images", [1, 2])
def test_processor_merge_matches_jax(n_images):
    """``<|image_N|>`` tags become runs of ``-N`` of each image's token
    count, text after them included; equal ids, positions and sizes."""
    from phi_3_vision_mlx_tpu.models.preprocess import Phi3VProcessor as JProc
    from phi_3_vision_mlx_tpu.models.tokenizer import ByteTokenizer as JTok

    imgs = [image(SHAPES["landscape"], seed=8), image(SHAPES["portrait"], seed=9)][:n_images]
    tags = "".join(f"<|image_{i}|>\n" for i in range(1, n_images + 1))
    prompt = f"<|user|>\n{tags}Describe them, then compare.<|end|>\n<|assistant|>\n"
    tproc, jproc = Phi3VProcessor(tokenizer=ByteTokenizer()), JProc(tokenizer=JTok())
    tproc.img_processor, jproc.img_processor = TIP(num_crops=4), JIP(num_crops=4)
    got, want = tproc(prompt, images=imgs), jproc(prompt, images=imgs)
    assert got.keys() == want.keys()
    for key in ("input_ids", "positions", "image_sizes"):
        np.testing.assert_array_equal(got[key], want[key])
    ids = got["input_ids"][0]
    assert (ids < 0).sum() == sum(TIP.count_tokens(h, w) for h, w in got["image_sizes"])
    assert ids[-1] >= 0  # the text after the images


# --- end to end: api.generate(images=...) -----------------------------------


def vision_checkpoint(root, name, q_bits=None, **overrides):
    """A ``tiny_vision`` checkpoint written by the JAX package
    (``vocab_size`` 32064, so the ByteTokenizer's special ids are valid);
    with ``q_bits`` its quantized copy with bf16-representable scales and
    biases, rewritten by the port's safetensors writer."""
    raw = str(root / name)
    JW.create_random_checkpoint(raw, "tiny_vision", vocab_size=VOCAB, **overrides)
    if q_bits is None:
        return raw
    JW.quantize_checkpoint(raw, raw + "_q", q_bits=q_bits)
    return bf16_planes(raw + "_q")


def bf16_planes(quant):
    """A copy of a quantized checkpoint with its scales and biases rounded to
    bf16-representable values."""
    out = quant + "r"
    flat = TW.load_safetensors_dir(quant)
    for key, t in flat.items():
        if key.endswith((".scales", ".biases")):
            flat[key] = t.to(torch.bfloat16).float()
    os.makedirs(out)
    for f in glob.glob(f"{quant}/*.json"):
        shutil.copy(f, out)
    TW.save_safetensors(f"{out}/model.safetensors", flat)
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("vision_ckpt")
    return {"fp32": vision_checkpoint(root, "tv"), "w4": vision_checkpoint(root, "tv4", q_bits=4)}


def load_pair(path, **kw):
    """(JAX (lm, proc), port (lm, proc)) over one checkpoint, 4 crops."""
    (jlm, jproc), (tlm, tproc) = JAPI._load(path, **kw), TAPI._load(path, device="cpu", **kw)
    jproc.img_processor, tproc.img_processor = JIP(num_crops=4), TIP(num_crops=4)
    return (jlm, jproc), (tlm, tproc)


@pytest.fixture(scope="module", params=["fp32", "w4"])
def pair(request, checkpoints):
    return load_pair(checkpoints[request.param])


@pytest.fixture(scope="module", params=["fp32", "w4"])
def qcache_pair(request, checkpoints):
    return load_pair(checkpoints[request.param], use_quantized_cache=True)


PROMPTS = {1: "What is shown in this image?", 2: "Compare the two images."}


def images_for(n):
    return [image(SHAPES["landscape"], seed=10), image(SHAPES["portrait"], seed=11)][:n]


def generate_both(pair, n_images, max_tokens=12):
    (jlm, jproc), (tlm, tproc) = pair
    kw = dict(max_tokens=max_tokens, verbose=False, stream=False, mute=True)
    imgs = images_for(n_images)
    return (JAPI.generate(PROMPTS[n_images], images=imgs, preload=(jlm, jproc), **kw),
            TAPI.generate(PROMPTS[n_images], images=imgs, preload=(tlm, tproc), **kw))


def prefill_both(pair, n_images, max_tokens=12):
    (jlm, jproc), (tlm, tproc) = pair
    prompt, imgs = TAPI._apply_chat_template(PROMPTS[n_images], images_for(n_images))
    d = jproc(prompt, imgs)
    jl, *_ = JE.run_prefill(jlm, d, max_tokens)
    tl, state, l_pad, window = TE.run_prefill(tlm, tproc(prompt, imgs), max_tokens)
    return np.asarray(jl), tl.numpy(), state, d


@pytest.mark.parametrize("n_images", [1, 2])
def test_generate_tokens_identical(pair, n_images):
    """``api.generate(images=...)``: the same greedy text (the ByteTokenizer
    renders unknown ids visibly, so equal text is equal ids)."""
    jout, tout = generate_both(pair, n_images)
    assert tout == jout and len(tout) > 0


@pytest.mark.parametrize("mode", ["raw", "hd", "pixel_values"])
@pytest.mark.parametrize("n_images", [1, 2])
def test_prefill_logits_match_jax(pair, n_images, mode, monkeypatch):
    """The last prefill logits of each of ``run_prefill``'s three vision
    branches, within ``LOGIT_REL_L2``."""
    if mode == "hd":
        monkeypatch.setenv("PHI3V_TPU_HOST_RESIZE", "1")
    elif mode == "pixel_values":
        monkeypatch.setenv("PHI3V_TPU_DEVICE_IMAGE", "0")
    jl, tl, state, d = prefill_both(pair, n_images)
    key = {"raw": "raw_images", "hd": "hd_images", "pixel_values": "pixel_values"}[mode]
    assert d.get(key) is not None
    assert tl.shape == jl.shape == (1, VOCAB)
    assert rel_l2(tl, jl) < LOGIT_REL_L2
    assert state.offset % TE.PROMPT_BUCKET == 0 and state.offset >= d["input_ids"].shape[1]


@pytest.mark.parametrize("n_images", [1, 2])
def test_quantized_cache_tokens_identical(qcache_pair, n_images, monkeypatch):
    """The int4 cache: the port writes the JAX package's quantized entries
    (``ReplayJaxCache``), and gives the same greedy text and, within
    ``LOGIT_REL_L2``, the same prefill logits."""
    (jlm, jproc), (tlm, tproc) = qcache_pair
    prompt, imgs = TAPI._apply_chat_template(PROMPTS[n_images], images_for(n_images))
    jl, jstate = _jax_decode(jlm, jproc(prompt, imgs), 12)
    replay = ReplayJaxCache(jstate, tlm.cfg.kv_quant.bits)
    monkeypatch.setattr(TM, "update_layer_chunk", replay)
    tl, state, _, _ = TE.run_prefill(tlm, tproc(prompt, imgs), 12)
    assert state.quantized and rel_l2(tl.numpy(), jl) < LOGIT_REL_L2
    jout, tout = generate_both(qcache_pair, n_images)
    assert tout == jout
    replay.check()


def test_list_prompt_with_images_raises(pair):
    """As in the JAX package: images go with a single prompt."""
    _, (tlm, tproc) = pair
    with pytest.raises(ValueError, match="list"):
        TE.generate_text(tlm, tproc, ["a", "b"], images=images_for(1), max_tokens=2, verbose=False)


def test_from_numpy_params_carries_the_vision_tree(checkpoints):
    """The JAX package's loaded 4-bit vision tree, carried across: the same
    tensors as the port's own load (patch weight OHWI), the same features."""
    path = checkpoints["w4"]
    jlm, _ = JAPI._load(path)
    tlm, _ = TAPI._load(path, device="cpu")
    carried = from_numpy_params(jax.tree_util.tree_map(np.asarray, jlm.params), jlm.cfg)
    flat_a, flat_b = TW.flatten_params(carried), TW.flatten_params(tlm.params)
    assert flat_a.keys() == flat_b.keys()
    assert any(".vision_embed_tokens." in k and k.endswith("fc1.qweight") for k in flat_a)
    for k in flat_a:
        assert torch.equal(flat_a[k], flat_b[k]), k
    patch = carried["model"]["vision_embed_tokens"]["img_processor"]["vision_model"]["embeddings"][
        "patch_embedding"]["weight"]
    assert patch.shape == (64, 14, 14, 3)
    pv = np.random.default_rng(12).normal(size=(1, 17, 3, 336, 336)).astype(np.float32)
    sizes = np.array([[336, 672]])
    (got,) = TV.compute_image_embeds(carried, tlm.cfg, pv, sizes)
    (want,) = JV.compute_image_embeds(jlm.params, jlm.cfg, pv, sizes)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=FEATURE_TOL, atol=FEATURE_TOL)


def test_port_random_checkpoint_loads_in_jax(tmp_path):
    """The port's ``create_random_checkpoint("tiny_vision")`` has the JAX
    checkpoint's config, keys, shapes and dtypes, loads in the JAX package,
    and gives its logits on an image prompt; its 4-bit copy (the port's
    ``quantize_checkpoint``, scales and biases then rounded to bf16) too."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JW.create_random_checkpoint(jdir, "tiny_vision", vocab_size=VOCAB)
    cfg = TW.create_random_checkpoint(tdir, "tiny_vision", seed=1, vocab_size=VOCAB)
    assert cfg.has_vision
    want, got = TW.load_safetensors_dir(jdir), TW.load_safetensors_dir(tdir)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
    TW.quantize_checkpoint(tdir, tdir + "_q")
    for path, n_images in ((tdir, 1), (bf16_planes(tdir + "_q"), 2)):
        jl, tl, _, _ = prefill_both(load_pair(path), n_images)
        assert rel_l2(tl, jl) < LOGIT_REL_L2
