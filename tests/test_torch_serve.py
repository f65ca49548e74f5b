"""Serving on the log with the PyTorch port, against the JAX engine.

The port's ``ServeEngine`` runs on the port's own ``BoltSystem``; with fp32
weights converted from JAX its greedy token streams equal the JAX engine's
token for token, although it prefills in one forward pass where the JAX
engine teacher-forces the prompt through its decode step. On MLA the two
score the first new token at different scales (the reference's absorbed
decode scales by (r + rope)^-1/2, its forward by (Dh + rope)^-1/2; ROADMAP.md
Queue 3, quirk 13): on deepseek-v2-lite-smoke the streams still match token
for token, and the port's engine equals the port's own teacher-forced
decode as well."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import BoltSystem as JaxBoltSystem  # noqa: E402
from repro.models.config import ModelConfig  # noqa: E402
from repro.models.lm import init_params as jax_init_params  # noqa: E402
from repro.serve import ModelDraft as JaxDraft  # noqa: E402
from repro.serve import ModelTarget as JaxTarget  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.speculative import sequential_decode as jax_sequential  # noqa: E402
from repro.streams import Producer as JaxProducer  # noqa: E402
from repro.streams import Topic as JaxTopic  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import BoltSystem  # noqa: E402
from repro_torch.serve import (ModelDraft, ModelTarget, ServeEngine,  # noqa: E402
                               SpeculativeDecoder, decode_response,
                               sequential_decode)
from repro_torch.streams import Producer, Topic  # noqa: E402

pytestmark = pytest.mark.slow  # JAX tracing; fast lane: -m 'not slow'


def _tiny_cfg(**kw):
    return ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                       n_kv_heads=1, d_ff=64, vocab_size=128,
                       tie_embeddings=True, attn_chunk=32, **kw)


def _requests(n):
    rng = np.random.default_rng(0)
    return [{"id": f"r{i}",
             "prompt": [int(t) for t in rng.integers(2, 128, 3 + 2 * i)]}
            for i in range(n)]


def _teacher_forced(cfg, model, reqs, gen_tokens):
    """The JAX engine's schedule in the port: the left-padded prompts fed
    through ``decode_step`` one position at a time, then greedy decode."""
    B, plen = len(reqs), max(len(r["prompt"]) for r in reqs)
    toks = np.full((B, plen), 1, np.int64)
    for i, r in enumerate(reqs):
        toks[i, plen - len(r["prompt"]):] = r["prompt"]
    caches = rt.init_caches(cfg, B, plen + gen_tokens, device="cpu")
    tokens = torch.from_numpy(toks)
    for t in range(plen):
        logits, caches = rt.decode_step(cfg, model, caches, tokens[:, t:t + 1], t)
    outs = [logits[:, -1, :cfg.vocab_size].argmax(-1)]
    for t in range(plen, plen + gen_tokens - 1):
        logits, caches = rt.decode_step(cfg, model, caches, outs[-1][:, None], t)
        outs.append(logits[:, -1, :cfg.vocab_size].argmax(-1))
    gen = torch.stack(outs, 1).numpy()
    return {r["id"]: [int(x) for x in gen[i]] for i, r in enumerate(reqs)}


def _serve(system, topic_cls, producer_cls, engine_cls, cfg, params, reqs,
           gen_tokens):
    req = topic_cls.create(system, "req")
    resp = topic_cls.create(system, "resp")
    prod = producer_cls(req)
    for r in reqs:
        prod.produce(r)
    prod.flush()
    eng = engine_cls(cfg, params, req, resp, batch_size=4)
    assert eng.poll_and_serve(gen_tokens=gen_tokens) == len(reqs)
    return req, resp, eng


@pytest.mark.parametrize("arch", ["tiny", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "llava-next-34b"])
def test_serve_engine_roundtrip_matches_jax(arch):
    """The port of test_serve_and_checkpoint.py::test_serve_engine_roundtrip,
    with the streams held equal to the JAX engine's (fp32) and to the port's
    own teacher-forced decode; granite's MoE smoke config routes the
    left-padded prefill batch where the JAX engine routes one position at a
    time (no drops at this size); deepseek-v2-lite's MLA prefills at another
    scale than its decode (quirk 13), and its streams match all the same;
    jamba's Mamba layers prefill by the log-depth scan, the left pads passed
    through the conv and the scan as the JAX engine's decode steps pass
    them, and decode continues from the prefill's final states; llava's
    text requests (no image prefix) through its 7 q heads padded to 8."""
    cfg = (_tiny_cfg(dtype="float32") if arch == "tiny"
           else get_smoke_config(arch).with_(dtype="float32"))
    jparams = jax_init_params(cfg, jax.random.key(0))
    model = rt.params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    reqs = _requests(3)                      # prompts of 3, 5 and 7 tokens
    system = BoltSystem(n_brokers=3)
    req, resp, eng = _serve(system, Topic, Producer, ServeEngine, cfg, model,
                            reqs, gen_tokens=6)
    log = resp.log
    out = decode_response(log.read(0, log.visible_tail))
    assert set(out) == {"r0", "r1", "r2"}
    assert all(len(toks) == 6 for toks in out.values())
    assert all(0 <= t < cfg.vocab_size for toks in out.values() for t in toks)
    assert out == _teacher_forced(cfg, model, reqs, gen_tokens=6)
    # durable request cursor: nothing left to serve...
    assert eng.poll_and_serve() == 0
    # ...even for a RESTARTED engine in the same consumer group
    assert ServeEngine(cfg, model, req, resp, batch_size=4).poll_and_serve() == 0
    assert system.serve_stats.requests == 3
    assert system.serve_stats.responses == 3
    assert system.serve_stats.tokens_out == 18

    jsystem = JaxBoltSystem(n_brokers=3)
    _, jresp, _ = _serve(jsystem, JaxTopic, JaxProducer, JaxServeEngine, cfg,
                         jparams, reqs, gen_tokens=6)
    jlog = jresp.log
    assert out == decode_response(jlog.read(0, jlog.visible_tail))
    # model_steps counts prompt positions, as the reference does
    assert system.serve_stats.model_steps == jsystem.serve_stats.model_steps


def test_engine_refuses_encoder_decoder():
    """whisper: a request on the log carries no audio frames, and the JAX
    engine's teacher-forced schedule (all-zero cross caches, RoPE at every
    position) could not agree with a prefill that encodes frames (quirk
    15), so the engine and the speculative adapters refuse the config; the
    model's own entry points serve it (test_torch_encdec.py)."""
    cfg = get_smoke_config("whisper-small").with_(dtype="float32")
    model = rt.init_params(cfg, 0, device="cpu")
    system = BoltSystem(n_brokers=2)
    req, resp = Topic.create(system, "req"), Topic.create(system, "resp")
    for make in (lambda: ServeEngine(cfg, model, req, resp),
                 lambda: ModelTarget(cfg, model), lambda: ModelDraft(cfg, model)):
        with pytest.raises(ValueError, match="encoder-decoder.*quirk 15"):
            make()


def test_torch_target_draft_speculative_is_exact():
    """The port of test_serve_on_log.py::test_jax_target_draft_speculative_is_exact:
    speculative == sequential on the torch adapters, and both equal the JAX
    adapters' stream (fp32)."""
    tcfg = _tiny_cfg(dtype="float32").with_(name="spec-target")
    dcfg = ModelConfig(name="spec-draft", n_layers=1, d_model=16, n_heads=2,
                       n_kv_heads=1, d_ff=32, vocab_size=128,
                       tie_embeddings=True, attn_chunk=32, dtype="float32")
    jt = jax.device_get(jax_init_params(tcfg, jax.random.key(0)))
    jd = jax.device_get(jax_init_params(dcfg, jax.random.key(1)))
    system = BoltSystem(n_brokers=2)
    target = ModelTarget(tcfg, rt.params_from_jax(tcfg, jt, device="cpu"),
                         stats=system.serve_stats)
    draft = ModelDraft(dcfg, rt.params_from_jax(dcfg, jd, device="cpu"),
                       stats=system.serve_stats)
    prompt = [5, 9, 13]
    ref = sequential_decode(target, prompt, 8)
    root = system.create_log("resp")
    dec = SpeculativeDecoder(target, draft, k=2, stats=system.serve_stats)
    res = dec.decode_request(root, "r0", prompt, 8)
    assert res.tokens == ref                      # exact despite a real draft
    assert decode_response(root.read(0, root.visible_tail)) == {"r0": ref}
    assert all(0 <= t < tcfg.vocab_size for t in res.tokens)
    assert ref == jax_sequential(JaxTarget(tcfg, jt), prompt, 8)
    assert (draft.propose(prompt + ref[:3], 4)
            == JaxDraft(dcfg, jd).propose(prompt + ref[:3], 4))


def _serve_example_configs():
    """``examples/serve.py``'s target and draft, unchanged: bf16 (the
    config's default), a target of 2 heads of 32 and a draft of 2 of 16."""
    cfg = ModelConfig(name="serve-demo", n_layers=2, d_model=64, n_heads=2,
                      n_kv_heads=1, d_ff=128, vocab_size=256,
                      tie_embeddings=True, attn_chunk=32)
    dcfg = ModelConfig(name="serve-draft", n_layers=1, d_model=32, n_heads=2,
                       n_kv_heads=1, d_ff=64, vocab_size=256,
                       tie_embeddings=True, attn_chunk=32)
    return cfg, dcfg


def test_serve_example_bf16_speculative_is_exact():
    """Quirk 16 pinned: ``examples/serve.py``'s two configurations in bf16,
    the reference's own weights carried into the port, on the CPU. Each
    model's bf16 logits hold against JAX's at test_torch_lm.py's bf16
    tolerance, and the port's speculative decode of the example's request
    equals its sequential decode token for token."""
    from repro.models.lm import forward as jax_forward
    tol = 0.15                                    # tests/test_torch_lm.py's LOGIT_TOL["bfloat16"]
    cfg, dcfg = _serve_example_configs()
    assert cfg.dtype == dcfg.dtype == "bfloat16" and dcfg.head_dim_ == 16
    models = {}
    for c, seed in ((cfg, 0), (dcfg, 1)):
        jparams = jax_init_params(c, jax.random.key(seed))
        models[c.name] = rt.params_from_jax(c, jax.device_get(jparams), device="cpu")
        toks = np.random.default_rng(seed).integers(2, 256, (2, 19)).astype(np.int32)
        jlogits = jax_forward(c, jparams, {"tokens": jax.numpy.asarray(toks)})[0]
        with torch.no_grad():
            logits = rt.forward(c, models[c.name], {"tokens": torch.from_numpy(toks).long()})[0]
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32),
                                   rtol=tol, atol=tol)
    system = BoltSystem(n_brokers=2)
    target = ModelTarget(cfg, models[cfg.name], stats=system.serve_stats)
    draft = ModelDraft(dcfg, models[dcfg.name], stats=system.serve_stats)
    rng = np.random.default_rng(0)
    for _ in range(4):                            # the example's four requests come first
        rng.integers(2, 256, 8)
    prompt = [int(t) for t in rng.integers(2, 256, 8)]
    ref = sequential_decode(target, prompt, 12)
    log = system.create_log("spec-responses")
    res = SpeculativeDecoder(target, draft, k=2, stats=system.serve_stats).decode_request(
        log, "spec-0", prompt, 12)
    assert res.tokens == ref
    assert decode_response(log.read(0, log.visible_tail)) == {"spec-0": ref}
