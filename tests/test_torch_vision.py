"""kafka_tpu_torch vision serving against the JAX package, on the CPU.

Images enter the decoder as a soft prompt: a ViT + projector
(models/vision.py) encodes each image into num_patches rows that replace
the embeddings of image_token_id placeholders at prefill.  Both packages
run the reference's `tiny-vision` preset (f32, byte tokenizer vocab +
the placeholder id 262, VisionConfig()) with the same weights, text and
tower, carried across from the JAX init.  Held equal:

* patchify and encode_images (atol 1e-5 in f32);
* the image-part helpers (count_images, prune_images,
  sentinelize_images, expand_placeholders, decode_image), fault C12
  included: an Anthropic-style {"type": "image"} part counts as an image;
* the engines' greedy streams for an image prompt, token for token, in
  one prefill chunk and in several (bucket 8), and two different images
  give different streams in both;
* the providers' image turn (prune, decode, encode off the event loop,
  expand), their vision pricing in count_prompt_tokens, and the
  construction check of the NUL sentinel's tokenizer;
* the HTTP image round trip on both servers (the prompt grows by
  num_patches; a malformed image is a 400), and the same typed 400 for
  an image part, of either wire form, from both text-only servers.

The engines are module-scoped and the shapes tiny: these run beside the
reference's timing-dependent files in the suite.
"""

import asyncio
import base64
import io

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from kafka_tpu.llm import images as jimages
from kafka_tpu.llm import utils as jutils
from kafka_tpu.models import get_config as jget_config
from kafka_tpu.models import init_params as jinit_params
from kafka_tpu.models import vision as jvision
from kafka_tpu.runtime import EngineConfig as JEngineConfig
from kafka_tpu.runtime import GenRequest as JGenRequest
from kafka_tpu.runtime import InferenceEngine as JInferenceEngine
from kafka_tpu_torch.llm import images as pimages
from kafka_tpu_torch.llm import utils as putils
from kafka_tpu_torch.models import get_config, params_from_jax
from kafka_tpu_torch.models import vision as pvision
from kafka_tpu_torch.runtime import EngineConfig, GenRequest, InferenceEngine

SHAPE = dict(max_batch=2, page_size=8, num_pages=96, max_pages_per_seq=12,
             prefill_buckets=(8, 32, 64))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _process_state_restored(monkeypatch):
    """create_app sets each package's process-wide tracing config, SLO
    targets and compile observatory: put them back after the test."""
    from collections import OrderedDict

    from kafka_tpu import tracing as rtracing
    from kafka_tpu.runtime import compile_log as rcomp
    from kafka_tpu.runtime import metrics as rmetrics
    from kafka_tpu_torch import tracing as ptracing
    from kafka_tpu_torch.runtime import compile_log as pcomp
    from kafka_tpu_torch.runtime import metrics as pmetrics

    for mod in (rcomp, pcomp):
        monkeypatch.setattr(mod, "_OBS", mod._OBS)

    for mod in (rtracing, ptracing):
        for name in ("_sample", "_capacity", "_span_cap", "_slow_ttft_ms",
                     "_slow_total_ms", "_profiling", "_persist_dir"):
            monkeypatch.setattr(mod, name, getattr(mod, name))
        monkeypatch.setattr(mod, "_traces", OrderedDict(mod._traces))
        monkeypatch.setattr(mod, "_by_request", dict(mod._by_request))
        monkeypatch.setattr(mod, "_counters", dict(mod._counters))
    for mod in (rmetrics, pmetrics):
        monkeypatch.setattr(mod, "_slo_override", dict(mod._slo_override))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, jax tower, port cfg, port params, port
    tower): the same weights in both packages."""
    jcfg = jget_config("tiny-vision").replace(dtype="float32")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    jv = jvision.vision_init_params(jcfg.vision, jcfg.hidden_size,
                                    jax.random.PRNGKey(1))
    cfg = get_config("tiny-vision").replace(dtype="float32")
    return (jcfg, jparams, jv, cfg,
            params_from_jax(jax.tree.map(np.asarray, jparams)),
            pvision.vision_params_from_jax(jax.tree.map(np.asarray, jv)))


def pixels(seed, n=1):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


def png_data_url(seed=0, size=16, solid=None) -> str:
    from PIL import Image

    if solid is not None:
        arr = np.full((size, size, 3), solid, np.uint8)
    else:
        arr = np.random.RandomState(seed).randint(0, 255, (size, size, 3),
                                                  np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def image_url_part(seed=0, solid=None):
    return {"type": "image_url",
            "image_url": {"url": png_data_url(seed, solid=solid)}}


def image_part(seed=0, solid=None):
    """The Anthropic-style wire form: {"type": "image", "source": ...}."""
    return {"type": "image",
            "source": {"data": png_data_url(seed, solid=solid)}}


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------


def test_patchify_equals_jax():
    vcfg = pvision.VisionConfig()
    x = pixels(3, n=2)
    np.testing.assert_array_equal(
        pvision.patchify(vcfg, torch.from_numpy(x)).numpy(),
        np.asarray(jvision.patchify(jvision.VisionConfig(), jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_images_equals_jax(model, seed):
    jcfg, _, jv, cfg, _, pv = model
    x = pixels(seed, n=2)
    want = np.asarray(jvision.encode_images(jv, jcfg.vision, jnp.asarray(x)))
    got = pvision.encode_images(pv, cfg.vision, torch.from_numpy(x))
    assert got.shape == (2, cfg.vision.num_patches, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_random_tower_is_seeded_and_shaped():
    vcfg = pvision.VisionConfig()
    a, b = (pvision.vision_init_params(
        vcfg, 48, torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a["layers"]["wqkv"], b["layers"]["wqkv"])
    assert a["proj_w2"].shape == (vcfg.projector_hidden, 48)
    assert a["pos_embed"].shape == (vcfg.num_patches, vcfg.hidden_size)


# ---------------------------------------------------------------------------
# image parts (fault C12)
# ---------------------------------------------------------------------------


def _conversation(n_url, n_image):
    parts = ([image_url_part(i) for i in range(n_url)]
             + [image_part(10 + i) for i in range(n_image)])
    return [{"role": "system", "content": "sys"},
            {"role": "user",
             "content": [{"type": "text", "text": "look\x00 here"}] + parts},
            {"role": "assistant", "content": "ok"},
            {"role": "user", "content": [image_part(30), image_url_part(31)]}]


@pytest.mark.parametrize("n_url,n_image", [(0, 1), (1, 1), (12, 12)])
def test_image_helpers_equal_jax(n_url, n_image):
    msgs = _conversation(n_url, n_image)
    assert putils.count_images(msgs) == jutils.count_images(msgs) \
        == n_url + n_image + 2
    assert putils.prune_images(msgs) == jutils.prune_images(msgs)
    assert putils.prune_images(msgs, 3) == jutils.prune_images(msgs, 3)
    got, got_parts = pimages.sentinelize_images(msgs)
    want, want_parts = jimages.sentinelize_images(msgs)
    assert got == want and got_parts == want_parts
    for part in want_parts[:2]:
        np.testing.assert_array_equal(pimages.decode_image(part, 32),
                                      jimages.decode_image(part, 32))
    ids = [5, 0, 7, 0, 9]
    assert [np.asarray(x).tolist() for x in pimages.expand_placeholders(
        ids, 0, 262, 16, 2)] == [np.asarray(x).tolist() for x in
                                 jimages.expand_placeholders(ids, 0, 262,
                                                             16, 2)]


def test_c12_anthropic_image_part_counts():
    """Fault C12: the port once counted only "image_url" parts, so a text
    part beside an "image" part was served as text alone."""
    msgs = [{"role": "user", "content": [{"type": "text", "text": "what?"},
                                         image_part(0)]}]
    assert putils.count_images(msgs) == jutils.count_images(msgs) == 1


@pytest.mark.parametrize("part", [
    {"type": "image_url", "image_url": {"url": "data:image/png;base64,@@"}},
    {"type": "image_url", "image_url": {"url": "https://example.com/a.png"}},
    {"type": "image"},
])
def test_bad_image_parts_raise_the_same_400(part):
    errs = []
    for mod in (jimages, pimages):
        with pytest.raises(mod.ImageDecodeError) as e:
            mod.decode_image(part, 32)
        # the message names the provider: "[tpu] ..." / "[torch] ..."
        errs.append((e.value.status_code, str(e.value).split("] ", 1)[1]))
    assert errs[0] == errs[1] and errs[1][0] == 400


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _engines(model, buckets):
    jcfg, jparams, _, cfg, params, _ = model
    shape = {**SHAPE, "prefill_buckets": buckets}
    j = JInferenceEngine(jcfg, jparams, JEngineConfig(
        **shape, multi_step=1, prefix_cache_entries=0, max_parked=0,
        attention_backend="xla", flight_ring=0), kv_dtype=jnp.float32)
    p = InferenceEngine(cfg, params, EngineConfig(**shape),
                        kv_dtype=torch.float32, device="cpu")
    return j, p


@pytest.fixture(scope="module")
def engines(model):
    return {b: _engines(model, b) for b in ((8, 32, 64), (8,))}


def _rows(model, x):
    jcfg, _, jv = model[:3]
    return np.asarray(jvision.encode_images(jv, jcfg.vision,
                                            jnp.asarray(x))[0], np.float32)


@pytest.mark.parametrize("buckets", [(8, 32, 64), (8,)],
                         ids=["one_chunk", "chunks_of_8"])
def test_image_stream_equals_jax(model, engines, buckets):
    """A 21-token prompt with 16 placeholders: one chunk, or three chunks
    of 8 (the image straddles chunk boundaries)."""
    cfg = model[3]
    P = cfg.vision.num_patches
    prompt = [5, 9] + [cfg.image_token_id] * P + [7, 3, 11]
    pos = np.arange(2, 2 + P, dtype=np.int32)
    rows = _rows(model, pixels(2))
    j, p = engines[buckets]
    outs = [e.generate(list(prompt), max_new_tokens=8, override_pos=pos,
                       override_rows=rows).output_ids for e in (j, p)]
    assert outs[1] == outs[0]
    text = p.generate(list(prompt), max_new_tokens=8).output_ids
    assert outs[1] != text


def test_two_images_give_different_streams(model, engines):
    """Solid black against solid white (the reference's test_vision
    case): different pixels condition generation in both packages."""
    cfg = model[3]
    P = cfg.vision.num_patches
    prompt = [5] + [cfg.image_token_id] * P + [7]
    pos = np.arange(1, 1 + P, dtype=np.int32)
    j, p = engines[(8, 32, 64)]
    streams = []
    for fill in (0.0, 1.0):
        rows = _rows(model, np.full((1, 32, 32, 3), fill, np.float32))
        streams.append([e.generate(list(prompt), max_new_tokens=8,
                                   override_pos=pos,
                                   override_rows=rows).output_ids
                        for e in (j, p)])
    assert streams[0][1] == streams[0][0] and streams[1][1] == streams[1][0]
    assert streams[0][1] != streams[1][1]


def test_batched_prefill_with_an_image_beside_text(model, engines):
    """Two same-bucket prompts prefill as one fused dispatch: the image
    lane's override rows land in its row only."""
    cfg = model[3]
    P = cfg.vision.num_patches
    img = [5, 9] + [cfg.image_token_id] * P + [7]
    pos = np.arange(2, 2 + P, dtype=np.int32)
    rows = _rows(model, pixels(4))
    txt = [int(t) for t in np.random.RandomState(5).randint(1, 262, 19)]
    j, p = engines[(8, 32, 64)]
    fused = []
    real = p._dev_prefill_batch
    p._dev_prefill_batch = lambda *a: (fused.append(a[-1] is not None),
                                       real(*a))[1]
    got = []
    try:
        for eng, Req in ((j, JGenRequest), (p, GenRequest)):
            a = Req(request_id="img", prompt_ids=list(img),
                    max_new_tokens=6, override_pos=pos, override_rows=rows)
            b = Req(request_id="txt", prompt_ids=list(txt),
                    max_new_tokens=6)
            eng.submit(a)
            eng.submit(b)
            eng.run_to_completion()
            got.append((a.output_ids, b.output_ids))
    finally:
        del p._dev_prefill_batch
    assert got[1] == got[0]
    assert fused == [True]  # one fused chunk, carrying the override


# ---------------------------------------------------------------------------
# the providers
# ---------------------------------------------------------------------------


class _NulSplitTokenizer:
    """A tokenizer whose NUL is two tokens: the sentinel cannot work."""

    stop_ids = (1,)
    vocab_size = 263

    def encode(self, text):
        return [2, 3] if text == "\x00" else [4] * len(text)

    def decode(self, ids):
        return "?" * len(ids)


@pytest.fixture(scope="module")
def providers(model, engines):
    """(reference provider, port provider) with the towers, over each
    package's one-chunk engine."""
    from kafka_tpu.llm import TPULLMProvider
    from kafka_tpu.models.tokenizer import ByteTokenizer as JByte
    from kafka_tpu_torch.llm import TorchLLMProvider
    from kafka_tpu_torch.models import ByteTokenizer

    j, p = engines[(8, 32, 64)]
    jp = TPULLMProvider(j, JByte(), model_name="tiny-vision",
                        vision_params=model[2])
    pp = TorchLLMProvider(p, ByteTokenizer(), model_name="tiny-vision",
                          vision_params=model[5])
    yield jp, pp
    jp.worker.stop()
    asyncio.run(pp.aclose())


async def _complete(provider, messages, max_tokens=8):
    text, usage = [], None
    async for chunk in provider.stream_completion(
            messages, temperature=0.0, max_tokens=max_tokens,
            prefix_key="thread-1"):
        if chunk.content:
            text.append(chunk.content)
        if chunk.usage is not None:
            usage = chunk.usage
    return "".join(text), usage


def test_provider_image_turn_equals_jax(providers):
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "what is it?"}, image_part(solid=0)]}]
    got = [asyncio.run(_complete(prov, msgs)) for prov in providers]
    assert got[1][0] == got[0][0]
    assert got[1][1] == got[0][1]
    # an image turn shares no prefix-cached KV (prefix_key dropped)
    assert got[1][1].get("prompt_tokens_details", {}).get(
        "cached_tokens", 0) == 0


def test_count_prompt_tokens_prices_patches(providers):
    pp = providers[1]
    base = [{"role": "user", "content": "hi"}]
    msgs = [{"role": "user", "content": [{"type": "text", "text": "hi"},
                                         image_url_part(0), image_part(1)]}]
    got = [prov.count_prompt_tokens(m) for prov in providers
           for m in (base, msgs)]
    assert got[2:] == got[:2]
    assert got[3] == got[2] + 2 * pp.model_cfg.vision.num_patches


def test_vision_refuses_a_tokenizer_without_a_nul_sentinel(model, engines):
    from kafka_tpu_torch.llm import TorchLLMProvider

    with pytest.raises(ValueError, match="single-token NUL"):
        TorchLLMProvider(engines[(8,)][1], _NulSplitTokenizer(),
                         vision_params=model[5])


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------


def _server_cfgs(tmp_path, **kw):
    from kafka_tpu.server import ServingConfig as JServingConfig
    from kafka_tpu_torch.server import ServingConfig

    return [C(**{**dict(db_path=str(tmp_path / f"{i}.db"), max_batch=2,
                        page_size=16, num_pages=256, max_pages_per_seq=96,
                        prefill_buckets=(256, 1024), warmup=False,
                        system_prompt="describe"), **kw})
            for i, C in enumerate((JServingConfig, ServingConfig))]


async def _serve(cfg, side, go):
    from aiohttp.test_utils import TestClient, TestServer

    if side == "ref":
        from kafka_tpu.server import create_app

        app = await create_app(cfg=cfg, tools=[], mcp_servers=[])
    else:
        from kafka_tpu_torch.server import create_app

        app = await create_app(cfg, tools=[], mcp_servers=[], device="cpu")
    async with TestClient(TestServer(app)) as client:
        return await go(client)


async def _post(client, model, content, max_tokens=12):
    r = await client.post("/v1/chat/completions", json={
        "model": model, "max_tokens": max_tokens, "temperature": 0.0,
        "messages": [{"role": "user", "content": content}]})
    return r.status, await r.json()


def test_http_image_round_trip_on_both_servers(tmp_path):
    async def go(client):
        s1, with_img = await _post(client, "tiny-vision", [
            {"type": "text", "text": "what is this? "}, image_url_part(
                solid=0)])
        s2, text_only = await _post(client, "tiny-vision", "what is this? ")
        s3, bad = await _post(client, "tiny-vision", [
            {"type": "image_url",
             "image_url": {"url": "data:image/png;base64,@@"}}], 4)
        return (s1, s2, s3, with_img["usage"]["prompt_tokens"]
                - text_only["usage"]["prompt_tokens"],
                isinstance(with_img["choices"][0]["message"]["content"],
                           str))

    cfgs = _server_cfgs(tmp_path, model_name="tiny-vision", dtype="float32")
    got = [asyncio.run(_serve(c, side, go))
           for c, side in zip(cfgs, ("ref", "port"))]
    assert got[1] == got[0] == (200, 200, 400, 16, True)


@pytest.mark.parametrize("make_part", [image_url_part, image_part],
                         ids=["image_url", "image"])
def test_text_only_servers_answer_images_with_the_same_400(tmp_path,
                                                          make_part):
    """Fault C12 end to end: the port's text-only server refuses an
    Anthropic-style image part as the reference's does."""
    async def go(client):
        status, body = await _post(client, "tiny", [
            {"type": "text", "text": "what?"}, make_part(0)], 4)
        # the message names the provider: "[tpu] ..." / "[torch] ..."
        err = dict(body["error"])
        err["message"] = err["message"].split("] ", 1)[1]
        return status, err

    cfgs = _server_cfgs(tmp_path, tiny_model=True, num_pages=160,
                        max_pages_per_seq=64, prefill_buckets=(256,))
    got = [asyncio.run(_serve(c, side, go))
           for c, side in zip(cfgs, ("ref", "port"))]
    assert got[1] == got[0]
    assert got[1][0] == 400 and "unsupported_content" in str(got[1])
