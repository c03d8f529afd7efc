"""CLI: HTTP transcription server over the micro-batching service.

POST /transcribe with a WAV body (or JSON {"path": ...}) returns
{"text", "segments", "latency_sec"}. POST /transcribe_stream streams
NDJSON: one {"partial": ...} line per decoded 30 s window as it completes,
then a final {"final": ...} line. GET /healthz and /stats for ops.

  python -m whisper_ipa.cli.serve --model small --port 8080 \
      --checkpoint checkpoints/whisper-ipa/best-checkpoint
"""

import argparse
import json
import queue
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": "not found"})

        def _read_audio(self, body):
            if self.headers.get("Content-Type", "").startswith(
                "application/json"
            ):
                return json.loads(body)["path"]
            from ..audio import load_audio_bytes

            return load_audio_bytes(body)

        def do_POST(self):
            if self.path not in ("/transcribe", "/transcribe_stream"):
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                audio = self._read_audio(body)
                if self.path == "/transcribe":
                    self._send(200, service.transcribe(audio))
                    return
                # streaming: NDJSON over chunked transfer — one line per
                # decoded 30 s window, then the final result
                partials: "queue.Queue" = queue.Queue()
                fut = service.submit(audio, on_partial=partials.put)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_chunk(obj):
                    data = (
                        json.dumps(obj, ensure_ascii=False) + "\n"
                    ).encode()
                    self.wfile.write(f"{len(data):X}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                while True:
                    if fut.done() and partials.empty():
                        break
                    try:
                        write_chunk({"partial": partials.get(timeout=0.05)})
                    except queue.Empty:
                        continue
                write_chunk({"final": fut.result()})
                self.wfile.write(b"0\r\n\r\n")
            except Exception as e:
                from ..serve_continuous import EngineOverloaded

                code = 503 if isinstance(e, EngineOverloaded) else 500
                try:
                    self._send(code, {"error": str(e)})
                except Exception:
                    pass  # headers may already be sent mid-stream

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="IPA transcription server")
    p.add_argument("--model", default="small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--language", default="en")
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument(
        "--kv-int4", action="store_true",
        help="nibble-packed int4 cross-KV cache: half of int8's cache "
        "memory — headroom for large models",
    )
    p.add_argument(
        "--quant-bits", type=int, default=None, choices=(4, 8),
        help="weight-only quantization: 8 (per-channel int8) or 4 "
        "(group-scaled packed int4) — cuts decode weight HBM traffic",
    )
    p.add_argument(
        "--draft-model", default=None,
        help="speculative decoding: draft model name (e.g. tiny), "
        "'ngram' (prompt lookup), or 'medusa' (trained one-shot heads "
        "via --medusa-weights); output tokens stay identical to plain "
        "greedy decoding",
    )
    p.add_argument(
        "--medusa-tree", action="store_true",
        help="tree-structured medusa verification "
        "(decode/medusa_tree.DEFAULT_TREE)",
    )
    p.add_argument(
        "--medusa-weights", default=None,
        help="safetensors file of Medusa heads (models/medusa.py) for "
        "--draft-model medusa",
    )
    p.add_argument("--draft-weights", default=None)
    p.add_argument(
        "--draft-checkpoint", default=None,
        help="trained draft-model checkpoint (e.g. cli.distill_draft "
        "output) overlaid onto the draft model; overlay mode "
        "auto-detects from the draft run's training_config.json",
    )
    p.add_argument("--draft-k", type=int, default=4)
    p.add_argument(
        "--continuous", action="store_true",
        help="in-flight batching engine (serve_continuous): requests join "
        "a running batch; per-token streaming; single 30 s window each",
    )
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--steps-per-sync", type=int, default=4)
    p.add_argument(
        "--adaptive-sync", action="store_true",
        help="continuous engine: long decode chunks when no joins are "
        "pending (throughput knob; raises worst-case join latency)",
    )
    p.add_argument(
        "--no-join-fast-sync", dest="join_fast_sync",
        action="store_false", default=True,
        help="disable the 1-round chunk after a join (TTFT fast path)",
    )
    p.add_argument(
        "--max-pending", type=int, default=None,
        help="continuous engine: reject (HTTP 503) when this many "
        "requests are already waiting — backpressure over unbounded "
        "queueing latency",
    )
    p.add_argument(
        "--dp", type=int, default=1,
        help="data-parallel ways: shard each batch over the mesh's "
        "'data' axis (multi-chip serving)",
    )
    p.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel ways: Megatron-shard the weights over the "
        "mesh's 'model' axis (for models too big for one chip)",
    )
    p.add_argument(
        "--warmup",
        action="store_true",
        help="Run one dummy batch before binding (absorbs XLA compiles)",
    )
    from . import add_overlay_flags

    add_overlay_flags(p)
    args = p.parse_args(argv)

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ..config import get_config
    from ..models import load_checkpoint_auto
    from ..serve import TranscriptionService
    from ..train.loop import load_or_init_params

    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, args.weights)
    if args.checkpoint:
        params, n = load_checkpoint_auto(
            args.checkpoint, params, args.full_ckpt
        )
        print(f"Loaded {n} tensors from {args.checkpoint}")

    draft_params = draft_cfg = medusa_params = None
    if args.draft_model == "medusa":
        from ..models.medusa import init_medusa_params, load_medusa

        medusa_params = (
            load_medusa(args.medusa_weights)
            if args.medusa_weights
            else init_medusa_params(cfg, n_heads=args.draft_k)
        )
        if not args.medusa_weights:
            print(
                "WARNING: untrained Medusa heads (no --medusa-weights): "
                "output stays exact but speculation will rarely accept"
            )
    elif args.draft_model and args.draft_model != "ngram":
        draft_cfg = get_config(args.draft_model)
        draft_params = load_or_init_params(
            args.draft_model, draft_cfg, args.draft_weights
        )
        if args.draft_checkpoint:
            draft_params, n = load_checkpoint_auto(
                args.draft_checkpoint, draft_params
            )
            print(f"Loaded {n} draft tensors from {args.draft_checkpoint}")

    mesh = None
    if args.dp * args.tp > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(data=args.dp, model=args.tp)

    if args.medusa_tree and args.draft_model != "medusa":
        raise SystemExit("--medusa-tree requires --draft-model medusa")
    if args.medusa_tree:
        from ..decode.medusa_tree import DEFAULT_TREE, tree_for_heads

        chosen_tree = (
            tree_for_heads(args.medusa_weights)
            if args.medusa_weights
            else DEFAULT_TREE
        )
    if args.continuous:
        from ..serve_continuous import ContinuousBatcher

        if args.tp > 1 and args.quant_bits is not None:
            raise SystemExit(
                "--continuous --tp shards float weights (TP_RULES); "
                "drop --quant-bits or use the micro-batch service"
            )
        if args.beam_size:
            raise SystemExit("--continuous is greedy-only (no beam)")
        if args.kv_int4:
            raise SystemExit(
                "--continuous supports int8 cross-KV only (the engine's "
                "persistent cache has no int4 path); drop --kv-int4"
            )
        if args.quant_bits is not None:
            from ..ops.quant import quantize_params

            params = quantize_params(params, bits=args.quant_bits)
        # match TranscriptionService's serving defaults: bf16
        # activations + int8 cross-attention KV cache
        service = ContinuousBatcher(
            params,
            cfg,
            slots=args.batch_size,
            max_new_tokens=args.max_new_tokens,
            steps_per_sync=args.steps_per_sync,
            join_fast_sync=args.join_fast_sync,
            adaptive_sync=args.adaptive_sync,
            language=args.language,
            bf16=True,
            kv_int8=True,
            draft_k=args.draft_k if args.draft_model else 0,
            draft_params=draft_params,
            draft_cfg=draft_cfg,
            medusa_params=medusa_params,
            medusa_tree=(
                chosen_tree
                if (args.medusa_tree and medusa_params is not None)
                else None
            ),
            mesh=mesh,
            tensor_parallel=args.tp > 1,
            max_pending=args.max_pending,
            # long-lived server: compile every chunk variant up front
            # (incl. the join_fast_sync rounds=1 program) so no request
            # ever pays a compile (ADVICE r4)
            prewarm=args.warmup,
        )
    else:
        service = TranscriptionService(
            params,
            cfg,
            batch_size=args.batch_size,
            max_wait_ms=args.max_wait_ms,
            language=args.language,
            beam_size=args.beam_size,
            quant_bits=args.quant_bits,
            draft_params=draft_params,
            draft_cfg=draft_cfg,
            draft_k=args.draft_k,
            medusa_params=medusa_params,
            medusa_tree=chosen_tree if args.medusa_tree else None,
            mesh=mesh,
            tensor_parallel=args.tp > 1,
            kv_int4=args.kv_int4,
        )
    if args.warmup:
        import numpy as np

        print("Warming up (compiling decode programs)...")
        service.transcribe(np.zeros(16000, np.float32))
        print("Warmup done.")

    server = ThreadingHTTPServer(
        (args.host, args.port), make_handler(service)
    )
    print(f"Serving on http://{args.host}:{args.port} (model {cfg.name})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()


if __name__ == "__main__":
    main()
