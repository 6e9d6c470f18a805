"""OpenAI-compatible HTTP server (stdlib only), from
``moe_infinity_tpu/entrypoints/openai/server.py``: /health, /v1/models,
/v1/completions (``n``, ``best_of``, ``logprobs``, ``stop``, ``echo``),
/v1/chat/completions (with SSE streaming) and /metrics, over the port's
``MoE`` facade. Requests serialize through an engine lock unless the
facade runs a continuous batcher, which batches concurrent requests on the
device; a streamed chat request then gets its tokens as they come. The
handler threads launch nothing themselves: ``MoE.generate`` names the
device in the thread that runs a direct generate, and the batcher's
scheduler thread names it once.

``build_server`` takes any tokenizer object with the ``transformers``
interface (``tokenizer(text, return_tensors="np").input_ids``, ``decode``,
``eos_token_id``, optionally ``chat_template``). ``main`` loads the
checkpoint's tokenizer with ``transformers``, which it needs.

Run:  python -m moe_infinity_tpu_torch.entrypoints.openai.server \
        --model <ckpt dir> [--port 8000] [--config engine.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from moe_infinity_tpu_torch.entrypoints.openai.protocol import (
    ChatCompletionRequest,
    CompletionRequest,
    chat_chunk,
    chat_response,
    completion_response,
    stop_list,
)
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("server")


class EngineHolder:
    """Engine + tokenizer + serialization lock."""

    def __init__(self, engine, tokenizer, model_name: str):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.lock = threading.Lock()
        self.requests = 0
        self.tokens_generated = 0

    def metrics(self) -> dict:
        m = {
            "requests": self.requests,
            "tokens_generated": self.tokens_generated,
            "model": self.model_name,
        }
        if hasattr(self.engine, "stats"):
            m["expert_cache"] = self.engine.stats()
        if hasattr(self.engine, "node_stats"):
            try:
                ns = self.engine.node_stats()
                hr, v = ns["hit_rate_matrix"], ns["visits"]
                # compact per-layer summary (full [L, E] planes stay on the
                # Python API; JSON metrics carry one row per layer)
                m["per_layer_hit_rate"] = [
                    round(float(r), 4) for r in
                    (hr * v).sum(1) / v.sum(1).clip(min=1)
                ]
            except Exception:
                pass
        return m

    def run(self, prompt: str, gen_kwargs, stop=None) -> tuple:
        """Returns (text, prompt_len, completion_len, finish_reason,
        logprobs_payload_or_None)."""
        ids = self.tokenizer(prompt, return_tensors="np").input_ids
        eos = self.tokenizer.eos_token_id
        # with a continuous batcher, concurrent requests batch on the
        # device; otherwise they serialize
        guard = (
            contextlib.nullcontext()
            if getattr(self.engine, "batcher", None) is not None
            else self.lock
        )
        with guard:
            self.requests += 1
            out = self.engine.generate(
                ids, eos_token_id=eos, pad_token_id=eos or 0, **gen_kwargs
            )
        prompt_len = ids.shape[1]
        gen_ids = out[0, prompt_len:]
        finish = "length"
        if eos is not None:
            keep = np.nonzero(gen_ids == eos)[0]
            if keep.size:
                gen_ids = gen_ids[: keep[0]]
                finish = "stop"
        lp = None
        if gen_kwargs.get("logprobs"):
            result = getattr(self.engine, "last_result", None)
            if result is not None and result.token_logprobs is not None:
                lp = self._logprobs_payload(gen_ids, result)
        text = self.tokenizer.decode(gen_ids, skip_special_tokens=True)
        for s in stop or []:
            i = text.find(s)
            if i != -1:
                text = text[:i]
                finish = "stop"
        self.tokens_generated += int(len(gen_ids))
        return text, prompt_len, int(len(gen_ids)), finish, lp

    def run_n(self, prompt: str, gen_kwargs, n: int, best_of=None, stop=None):
        """n>1 / best_of sampling: duplicate the prompt into a batch of
        max(n, best_of) rows (rows draw independently), score candidates by
        mean token logprob when best_of > n, return the top n as
        (text, finish, logprobs) tuples plus (prompt_len, completion_total)."""
        k = max(n, best_of or n)
        ids = self.tokenizer(prompt, return_tensors="np").input_ids
        eos = self.tokenizer.eos_token_id
        batch = np.repeat(ids, k, axis=0)
        kw = dict(gen_kwargs)
        scoring = (best_of or n) > n
        if scoring:
            kw.setdefault("logprobs", 1)
        with self.lock:
            self.requests += 1
            out = self.engine.generate(
                batch, eos_token_id=eos, pad_token_id=eos or 0, **kw
            )
        result = getattr(self.engine, "last_result", None)
        prompt_len = ids.shape[1]
        rows = []
        for b in range(k):
            gen_ids = out[b, prompt_len:]
            finish = "length"
            if eos is not None:
                hit = np.nonzero(gen_ids == eos)[0]
                if hit.size:
                    gen_ids = gen_ids[: hit[0]]
                    finish = "stop"
            score = 0.0
            if (
                result is not None
                and result.token_logprobs is not None
                and len(gen_ids)
            ):
                m = min(len(gen_ids), result.token_logprobs.shape[1])
                score = float(result.token_logprobs[b, :m].mean())
            text = self.tokenizer.decode(gen_ids, skip_special_tokens=True)
            for s in stop or []:
                i = text.find(s)
                if i != -1:
                    text = text[:i]
                    finish = "stop"
            lp = None
            if gen_kwargs.get("logprobs") and result is not None:
                lp = self._logprobs_payload(
                    gen_ids, result, row=b
                )
            self.tokens_generated += int(len(gen_ids))
            rows.append((score, text, finish, lp, int(len(gen_ids))))
        rows.sort(key=lambda r: -r[0])
        return rows[:n], prompt_len

    def _logprobs_payload(self, gen_ids, result, row: int = 0) -> dict:
        """OpenAI completions `logprobs` object for choice 0."""
        tl = result.token_logprobs[row]
        top_lp, top_tok = result.top_logprobs[row], result.top_tokens[row]
        tokens, token_logprobs, tops, offsets = [], [], [], []
        off = 0
        n = min(len(gen_ids), tl.shape[0])
        for i in range(n):
            piece = self.tokenizer.decode([int(gen_ids[i])])
            tokens.append(piece)
            offsets.append(off)
            off += len(piece)
            token_logprobs.append(float(tl[i]))
            tops.append(
                {
                    self.tokenizer.decode([int(t)]): float(v)
                    for t, v in zip(top_tok[i], top_lp[i])
                }
            )
        return {
            "tokens": tokens,
            "token_logprobs": token_logprobs,
            "top_logprobs": tops,
            "text_offset": offsets,
        }

    def chat_prompt(self, messages) -> str:
        if getattr(self.tokenizer, "chat_template", None):
            return self.tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        return (
            "\n".join(f"{m.get('role')}: {m.get('content')}" for m in messages)
            + "\nassistant:"
        )


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def holder(self) -> "EngineHolder":
        return self.server.holder

    def log_message(self, fmt, *args):  # route through the port's logger
        logger.info("%s %s", self.address_string(), fmt % args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._json(code, {"error": {"message": message, "code": code}})

    # ---- GET ----------------------------------------------------------
    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/metrics":
            self._json(200, self.holder.metrics())
        elif self.path == "/v1/models":
            self._json(
                200,
                {
                    "object": "list",
                    "data": [
                        {
                            "id": self.holder.model_name,
                            "object": "model",
                            "owned_by": "moe_infinity_tpu",
                        }
                    ],
                },
            )
        else:
            self._error(404, f"no route {self.path}")

    # ---- POST ---------------------------------------------------------
    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = json.loads(self.rfile.read(length) or b"{}")
        except Exception as e:
            return self._error(400, f"bad json: {e}")
        try:
            if self.path == "/v1/completions":
                self._completions(data)
            elif self.path == "/v1/chat/completions":
                self._chat(data)
            else:
                self._error(404, f"no route {self.path}")
        except Exception as e:  # surface engine errors as 500s
            logger.error("request failed: %s", e)
            try:
                self._error(500, str(e))
            except Exception:
                pass

    def _completions(self, data):
        req = CompletionRequest.from_json(data)
        prompts = req.prompt if isinstance(req.prompt, list) else [req.prompt]
        choices = []
        pt = ct = 0
        multi = req.n > 1 or (req.best_of or 0) > 1
        for i, p in enumerate(prompts):
            if multi:
                rows, p_len = self.holder.run_n(
                    p, req.to_generate_kwargs(), req.n, req.best_of,
                    stop=stop_list(req.stop),
                )
                pt += p_len
                for _, text, finish, lp, c_len in rows:
                    ct += c_len
                    choices.append(
                        {
                            "index": len(choices),
                            "text": (p + text) if req.echo else text,
                            "logprobs": lp,
                            "finish_reason": finish,
                        }
                    )
                continue
            text, p_len, c_len, finish, lp = self.holder.run(
                p, req.to_generate_kwargs(), stop=stop_list(req.stop)
            )
            pt += p_len
            ct += c_len
            choices.append(
                {
                    "index": i,
                    "text": (p + text) if req.echo else text,
                    "logprobs": lp,
                    "finish_reason": finish,
                }
            )
        resp = completion_response(req.model or self.holder.model_name, "", pt, ct)
        resp["choices"] = choices
        self._json(200, resp)

    def _chat(self, data):
        req = ChatCompletionRequest.from_json(data)
        model = req.model or self.holder.model_name
        if req.stream and getattr(self.holder.engine, "batcher", None) is not None:
            self.holder.requests += 1
            return self._chat_stream_tokens(req, model)
        prompt = self.holder.chat_prompt(req.messages)
        text, p_len, c_len, finish, _ = self.holder.run(
            prompt, req.to_generate_kwargs(), stop=stop_list(req.stop)
        )
        if req.stream:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_chunk(obj):
                payload = f"data: {json.dumps(obj)}\n\n".encode()
                self.wfile.write(hex(len(payload))[2:].encode() + b"\r\n")
                self.wfile.write(payload + b"\r\n")

            rid = "chatcmpl-stream"
            send_chunk(chat_chunk(rid, model, text))
            send_chunk(chat_chunk(rid, model, "", finish="stop"))
            done = b"data: [DONE]\n\n"
            self.wfile.write(hex(len(done))[2:].encode() + b"\r\n")
            self.wfile.write(done + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        else:
            self._json(200, chat_response(model, text, p_len, c_len, finish))

    def _chat_stream_tokens(self, req, model):
        """True token-level SSE streaming via the continuous batcher."""
        prompt = self.holder.chat_prompt(req.messages)
        tok = self.holder.tokenizer
        ids = tok(prompt, return_tensors="np").input_ids[0]
        eos = tok.eos_token_id
        q: "queue.Queue" = queue.Queue()
        gk = req.to_generate_kwargs()
        gk.pop("logprobs", None)
        fut = self.holder.engine.batcher.submit(
            ids,
            max_new_tokens=gk.pop("max_new_tokens"),
            eos_token_id=eos,
            on_token=q.put,
            **gk,
        )
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def send_chunk(obj):
            payload = f"data: {json.dumps(obj)}\n\n".encode()
            self.wfile.write(hex(len(payload))[2:].encode() + b"\r\n")
            self.wfile.write(payload + b"\r\n")

        rid = "chatcmpl-stream"
        emitted = 0
        finished = False
        while True:
            try:
                t = q.get(timeout=0.2)
            except queue.Empty:
                if finished:
                    break  # queue fully drained after completion
                finished = fut.done()
                continue
            if eos is not None and t == eos:
                continue  # drop the terminator, keep draining
            send_chunk(chat_chunk(rid, model, tok.decode([t])))
            emitted += 1
        self.holder.tokens_generated += emitted
        send_chunk(chat_chunk(rid, model, "", finish="stop"))
        done = b"data: [DONE]\n\n"
        self.wfile.write(hex(len(done))[2:].encode() + b"\r\n")
        self.wfile.write(done + b"\r\n")
        self.wfile.write(b"0\r\n\r\n")


class _Server(ThreadingHTTPServer):
    daemon_threads = True


def build_server(engine, tokenizer, model_name: str, host: str, port: int):
    srv = _Server((host, port), Handler)
    srv.holder = EngineHolder(engine, tokenizer, model_name)
    return srv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True, help="HF checkpoint directory")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--config", default=None, help="EngineConfig json file")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(
            "the server loads the checkpoint's tokenizer with transformers, which is "
            "not installed; install it, or call build_server() with a tokenizer object"
        ) from e

    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.utils.config import EngineConfig

    config = EngineConfig.load_from_file(args.config) if args.config else None
    tokenizer = AutoTokenizer.from_pretrained(args.model)
    engine = MoE(args.model, config, device=args.device)
    server = build_server(engine, tokenizer, args.model, args.host, args.port)
    logger.info("serving %s on %s:%d", args.model, args.host, args.port)
    try:
        server.serve_forever()
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
