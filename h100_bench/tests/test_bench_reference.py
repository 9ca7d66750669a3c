"""The plain reference against the program on the CPU at tiny widths, in
float32: tokenization, the decoder's logits and the image embedding.  The
reference was written from the published description; these show it
computes what the program computes where both are exact."""

import numpy as np
import torch

from h100_bench import weights
from h100_bench.reference import clip, decoder, image, tokenizer
from h100_bench.tests.tiny import TEXT, VISION
from h100_bench.traffic import CHAT_TURN


def _port(cfg_dict):
    from phi_3_vision_mlx_tpu_torch.core.config import config_from_dict
    from phi_3_vision_mlx_tpu_torch.core.weights import prepare_params

    def f32(tree):  # the bf16 leaves' values, in the float32 the tiny model computes in
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float() if tree.is_floating_point() else tree

    cfg = config_from_dict(cfg_dict)
    return cfg, prepare_params(f32(weights.checkpoint(cfg_dict, 7, "cpu")), cfg)


def test_prompt_ids_match_the_program():
    from phi_3_vision_mlx_tpu_torch.models.image_processor import Phi3VImageProcessor
    from phi_3_vision_mlx_tpu_torch.models.preprocess import Phi3VProcessor
    from phi_3_vision_mlx_tpu_torch.models.tokenizer import ByteTokenizer
    from phi_3_vision_mlx_tpu_torch.utils.media import ArrayImage

    proc = Phi3VProcessor(tokenizer=ByteTokenizer())
    proc.img_processor = Phi3VImageProcessor(4)
    text = CHAT_TURN.format(body="say it twice, plainly.")
    assert tokenizer.prompt_ids(text) == list(np.asarray(proc(text)["input_ids"])[0])
    for h, w in ((60, 80), (90, 40), (336, 336)):
        prompt = CHAT_TURN.format(body="<|image_1|>\nwhat is this?")
        got = proc(prompt, [ArrayImage(np.zeros((h, w, 3), np.uint8))])
        n = image.tokens(*image.grid(h, w, 4)[0])
        assert tokenizer.prompt_ids(prompt, [n]) == list(np.asarray(got["input_ids"])[0])


@torch.no_grad()
def test_decoder_logits_match_the_program():
    from phi_3_vision_mlx_tpu_torch.models.phi3 import forward_nocache

    cfg, params = _port(TEXT)
    ids = tokenizer.prompt_ids(CHAT_TURN.format(body="a" * 40 + " the quick brown fox"))
    ours = forward_nocache(params, cfg, torch.tensor([ids]))[0].float()
    ckpt = weights.checkpoint(TEXT, 7, "cpu")
    ref = decoder.logits(TEXT, ckpt, [(decoder.embed(ckpt["model"]["embed_tokens"], torch.tensor(ids)), 0)])[0]
    assert ref.shape == ours.shape
    assert float((ref - ours).abs().max()) < 1e-4 * float(ref.abs().max())


@torch.no_grad()
def test_image_embedding_matches_the_program():
    from phi_3_vision_mlx_tpu_torch.models.image_processor import Phi3VImageProcessor
    from phi_3_vision_mlx_tpu_torch.models.vision import image_features
    from phi_3_vision_mlx_tpu_torch.utils.media import ArrayImage

    cfg, params = _port(VISION)
    ckpt = weights.checkpoint(VISION, 7, "cpu")
    vp = ckpt["model"]["vision_embed_tokens"]
    proc = Phi3VImageProcessor(4)
    for h, w in ((60, 80), (90, 40)):
        px = np.random.default_rng(h).integers(0, 256, (h, w, 3), dtype=np.uint8)
        d = proc([ArrayImage(px)], raw=True)
        d["image_sizes"] = np.asarray(d["image_sizes"])
        ours = image_features(params, cfg, d)[0][0].float()
        crops, (rows, cols) = image.crops(px, 4, "cpu")
        ref = clip.image_embedding(vp, VISION["vision_config"], crops, rows, cols)
        assert ref.shape == ours.shape
        assert float((ref - ours).abs().max()) < 1e-4 * float(ref.abs().max())
