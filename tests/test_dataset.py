"""Dataset/input-pipeline tests + an end-to-end training smoke test."""

import json
import os

import numpy as np
import pytest

from whisper_ipa.audio import SAMPLE_RATE, write_wav
from whisper_ipa.data import IPADataset, PrefetchLoader, create_data_loader
from whisper_ipa.tokenizer import get_tokenizer


def make_synthetic_dataset(root, n=6, seconds=0.5):
    """Sine-wave WAVs + pipeline-schema JSON (the test fixture pattern the
    reference lacked — SURVEY §4 implication (c))."""
    os.makedirs(root, exist_ok=True)
    entries = []
    ipas = ["kæt", "bʌtn̩", "ə̥tʃ", "aːm", "ɡɯɣ", "n̩æp"]
    for i in range(n):
        t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
        audio = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, audio.astype(np.float32))
        entries.append(
            {
                "audio_path": path,
                "ipa_transcription": ipas[i % len(ipas)],
                "speaker_id": f"spk{i}",
                "dataset_source": "synthetic",
            }
        )
    json_path = os.path.join(root, "dataset.json")
    with open(json_path, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    return json_path


@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("ds")))


@pytest.fixture(scope="module")
def dataset(dataset_json):
    return create_data_loader(dataset_json, n_mels=80)


class TestIPADataset:
    def test_len_and_getitem(self, dataset):
        assert len(dataset) == 6
        sample = dataset[0]
        assert sample["ipa_text"] == "kæt"
        assert sample["audio"].dtype == np.float32

    def test_get_batch_shapes(self, dataset):
        batch = dataset.get_batch([0, 1, 2, 3])
        assert batch["mel_features"].shape == (4, 3000, 80)
        assert batch["tokens"].ndim == 2
        assert len(batch["ipa_texts"]) == 4

    def test_tokenization_contract(self, dataset):
        """SOT seq + BPE + EOT, padded with EOT (reference
        ipa_data_loader._tokenize_ipa_batch)."""
        tok = dataset.tokenizer
        batch = dataset.get_batch([0, 1])
        tokens = batch["tokens"]
        assert tuple(tokens[0, :4]) == tok.sot_sequence_including_notimestamps
        assert tokens[0, -1] == tok.eot
        # round-trip: decode_text recovers the IPA string
        assert tok.decode_text(tokens[0].tolist()) == batch["ipa_texts"][0]

    def test_pad_tokens_to(self, dataset):
        batch = dataset.get_batch([0], pad_tokens_to=64)
        assert batch["tokens"].shape[1] == 64

    def test_mel_cache(self, dataset_json, tmp_path):
        cache = str(tmp_path / "melcache")
        ds = create_data_loader(
            dataset_json, n_mels=80, mel_cache_dir=cache
        )
        m1 = ds.mel(0)
        files = os.listdir(cache)
        assert len(files) == 1
        m2 = ds.mel(0)  # cache hit (float16 round-trip)
        assert np.max(np.abs(m1 - m2)) < 2e-3


class TestPrefetchLoader:
    def test_yields_requested_steps(self, dataset):
        loader = PrefetchLoader(dataset, batch_size=2, num_steps=3, seed=0)
        batches = list(loader)
        assert len(batches) == 3
        for b in batches:
            assert b["mel_features"].shape[0] == 2
            # bucketing pads token length to a power of two
            assert b["tokens"].shape[1] in (32, 64, 128, 256, 448)

    def test_deterministic_with_seed(self, dataset):
        a = [b["audio_paths"] for b in PrefetchLoader(dataset, 2, 3, seed=7)]
        b = [b["audio_paths"] for b in PrefetchLoader(dataset, 2, 3, seed=7)]
        assert a == b


class TestEndToEndTraining:
    def test_train_smoke(self, dataset_json, tmp_path):
        """Two real steps of train() end-to-end on synthetic data."""
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        from whisper_ipa.train.loop import train

        # register a micro model to keep CPU compile time down
        config_mod.CONFIGS["test-micro"] = replace(
            config_mod.CONFIGS["test-tiny"], name="test-micro"
        )
        out = str(tmp_path / "run")
        summary = train(
            model_name="test-micro",
            train_data_path=dataset_json,
            test_data_path=dataset_json,
            output_dir=out,
            num_steps=2,
            batch_size=2,
            learning_rate=1e-4,
            validate_every=0,
            save_every=2,
            data_parallel=True,
            final_validate=False,
        )
        assert os.path.isfile(os.path.join(out, "training_config.json"))
        assert os.path.isfile(os.path.join(out, "training_log.csv"))
        assert os.path.isdir(os.path.join(out, "checkpoint-2"))
        assert np.isfinite(summary["final_loss"])


class TestPrefetchClose:
    def test_close_mid_iteration(self, dataset):
        loader = PrefetchLoader(dataset, batch_size=2, num_steps=50, seed=0)
        it = iter(loader)
        next(it)
        loader.close()  # must not deadlock or raise


class TestFailureHandling:
    def test_emergency_checkpoint_on_step_error(self, dataset_json, tmp_path,
                                                monkeypatch):
        """A mid-training exception must leave a usable checkpoint and stop
        (reference broke with no save — SURVEY §5 failure detection)."""
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        import whisper_ipa.train.loop as loop_mod

        config_mod.CONFIGS["test-micro3"] = replace(
            config_mod.CONFIGS["test-tiny"], name="test-micro3"
        )

        real_step = loop_mod.train_step
        calls = {"n": 0}

        def exploding_step(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] >= 3:
                raise RuntimeError("injected failure")
            return real_step(*args, **kwargs)

        monkeypatch.setattr(loop_mod, "train_step", exploding_step)
        out = str(tmp_path / "run")
        loop_mod.train(
            model_name="test-micro3",
            train_data_path=dataset_json,
            test_data_path=dataset_json,
            output_dir=out,
            num_steps=10,
            batch_size=2,
            validate_every=0,
            save_every=0,
            data_parallel=False,
            final_validate=False,
        )
        # emergency checkpoint written at the failing step
        ckpts = [d for d in os.listdir(out) if d.startswith("checkpoint-")]
        assert ckpts, os.listdir(out)
        assert os.path.isfile(
            os.path.join(out, ckpts[0], "model.safetensors")
        )


class TestLoaderErrorPropagation:
    def test_worker_exception_raises_in_consumer(self, dataset_json, tmp_path):
        """A bad audio path must raise in the training loop, not silently
        truncate the run."""
        import copy

        ds = create_data_loader(dataset_json, n_mels=80)
        broken = copy.deepcopy(ds.data)
        for e in broken:
            e["audio_path"] = "/nonexistent/missing.wav"
        ds.data = broken
        loader = PrefetchLoader(ds, batch_size=2, num_steps=3, seed=0)
        with pytest.raises(RuntimeError, match="input pipeline"):
            list(loader)


class TestJSONL:
    def test_jsonl_loading(self, dataset_json, tmp_path):
        import json as _json

        with open(dataset_json) as f:
            entries = _json.load(f)
        jsonl = str(tmp_path / "ds.jsonl")
        with open(jsonl, "w") as f:
            for e in entries:
                f.write(_json.dumps(e, ensure_ascii=False) + "\n")
        ds = create_data_loader(jsonl, n_mels=80)
        assert len(ds) == len(entries)
        assert ds[0]["ipa_text"] == entries[0]["ipa_transcription"]


class TestTokenTruncation:
    def test_overlong_transcript_truncated_with_eot(self, dataset):
        """A transcript tokenizing past max_token_len must be truncated
        (keeping the final EOT) instead of overrunning n_text_ctx and
        aborting the run (ADVICE r1)."""
        import copy

        ds = copy.copy(dataset)
        ds.data = copy.deepcopy(dataset.data)
        ds.max_token_len = 16
        ds._truncation_warned = False
        ds.data[0]["ipa_transcription"] = "aɪ " * 200  # tokenizes way past 16
        batch = ds.get_batch([0, 1])
        assert batch["tokens"].shape[1] <= 16
        row = batch["tokens"][0]
        assert row[-1] == ds.tokenizer.eot
        assert tuple(row[:4]) == ds.tokenizer.sot_sequence_including_notimestamps


class TestScheduleLogging:
    def test_logged_lr_matches_schedule(self, dataset_json, tmp_path):
        """training_log.csv must record schedule(step), not the static lr,
        when warmup/decay is active (VERDICT r1 weak #4)."""
        import csv as _csv
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        from whisper_ipa.train.loop import train
        from whisper_ipa.train.optimizer import make_schedule

        config_mod.CONFIGS["test-micro-lr"] = replace(
            config_mod.CONFIGS["test-tiny"], name="test-micro-lr"
        )
        out = str(tmp_path / "run")
        lr, steps, warmup = 1e-3, 3, 2
        train(
            model_name="test-micro-lr",
            train_data_path=dataset_json,
            test_data_path=dataset_json,
            output_dir=out,
            num_steps=steps,
            batch_size=2,
            learning_rate=lr,
            warmup_steps=warmup,
            lr_decay="cosine",
            validate_every=0,
            save_every=0,
            data_parallel=False,
            final_validate=False,
        )
        schedule = make_schedule(
            lr, warmup_steps=warmup, decay="cosine", total_steps=steps
        )
        with open(os.path.join(out, "training_log.csv")) as f:
            rows = list(_csv.reader(f))
        header, body = rows[0], rows[1:]
        step_i, lr_i = header.index("step"), header.index("lr")
        assert body  # steps 1..3 all log (step <= 5 fast path)
        for row in body:
            step = int(row[step_i])
            assert float(row[lr_i]) == pytest.approx(
                float(schedule(step)), rel=1e-2
            )
        # warmup actually varies the lr: first and last logged differ
        assert float(body[0][lr_i]) != float(body[-1][lr_i])


class TestEmergencySaveDonation:
    def test_handler_survives_unsaveable_state(self, dataset_json, tmp_path,
                                               monkeypatch):
        """If the emergency save itself fails (donated buffers deleted),
        train() must report and stop — not raise out of the handler
        (ADVICE r1: loop.py emergency checkpoint)."""
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        import whisper_ipa.train.loop as loop_mod

        config_mod.CONFIGS["test-micro-don"] = replace(
            config_mod.CONFIGS["test-tiny"], name="test-micro-don"
        )

        def exploding_step(*args, **kwargs):
            raise RuntimeError("injected failure")

        def exploding_save(*args, **kwargs):
            raise RuntimeError("Array has been deleted")

        monkeypatch.setattr(loop_mod, "train_step", exploding_step)
        monkeypatch.setattr(loop_mod, "save_checkpoint", exploding_save)
        out = str(tmp_path / "run")
        summary = loop_mod.train(
            model_name="test-micro-don",
            train_data_path=dataset_json,
            test_data_path=dataset_json,
            output_dir=out,
            num_steps=5,
            batch_size=2,
            validate_every=0,
            save_every=0,
            data_parallel=False,
            final_validate=False,
        )
        assert summary is not None  # loop exited cleanly via the handler


class TestEncoderFeatureCache:
    def test_train_with_cached_features(self, dataset_json, tmp_path):
        """cache_encoder=True precomputes frozen-encoder outputs and trains
        on them; loss must stay finite and match the shape contract."""
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        from whisper_ipa.train.loop import train

        config_mod.CONFIGS["test-micro-fc"] = replace(
            config_mod.CONFIGS["test-tiny"], name="test-micro-fc"
        )
        out = str(tmp_path / "run")
        summary = train(
            model_name="test-micro-fc",
            train_data_path=dataset_json,
            test_data_path=dataset_json,
            output_dir=out,
            num_steps=2,
            batch_size=2,
            validate_every=0,
            save_every=0,
            data_parallel=False,
            final_validate=False,
            cache_encoder=True,
        )
        assert np.isfinite(summary["final_loss"])
        # the cache directory holds one .npy per sample
        import json as _json

        cache = os.path.join(out, "encoder_cache")
        n_samples = len(_json.load(open(dataset_json)))
        assert len(os.listdir(cache)) == n_samples

    def test_cached_loss_matches_uncached(self, dataset_json, tmp_path):
        """One step on cached features gives the same loss as computing the
        encoder in-step (the cache is mathematically a no-op)."""
        from dataclasses import replace

        import jax.numpy as jnp

        import whisper_ipa.config as config_mod
        from whisper_ipa.data import create_data_loader
        from whisper_ipa.models import init_params
        from whisper_ipa.train import create_train_state, train_step

        cfg = replace(config_mod.CONFIGS["test-tiny"], name="t")
        ds = create_data_loader(dataset_json, n_mels=cfg.n_mels)
        params = init_params(cfg, seed=0)
        batch = ds.get_batch([0, 1])
        mel = jnp.asarray(batch["mel_features"])
        tokens = jnp.asarray(batch["tokens"])

        # precompute BEFORE any train_step: train_step donates its state,
        # deleting the param buffers it shares (see CLAUDE.md gotchas)
        ds.precompute_features(
            params, cfg, str(tmp_path / "feat"), batch_size=2,
            dtype_name="float32",
        )
        fb = ds.get_batch([0, 1])
        feats = jnp.asarray(fb["mel_features"])
        assert feats.shape[1] == cfg.n_audio_ctx

        state1, tx = create_train_state(params, learning_rate=1e-4)
        _, loss_mel = train_step(
            state1, mel, tokens, cfg, tx, eot=ds.tokenizer.eot,
            dtype_name="float32",
        )

        params2 = init_params(cfg, seed=0)
        state2, tx2 = create_train_state(params2, learning_rate=1e-4)
        _, loss_feat = train_step(
            state2, feats, tokens, cfg, tx2, eot=ds.tokenizer.eot,
            dtype_name="float32", inputs_are_features=True,
        )
        # float16 disk round-trip: small tolerance
        assert float(loss_mel) == pytest.approx(float(loss_feat), abs=2e-3)


class TestStepsPerCall:
    def test_train_steps_per_call_matches_sequential(
        self, dataset_json, tmp_path
    ):
        """train(steps_per_call=4) == train(steps_per_call=1): identical
        final loss + params, checkpoints land on the same boundaries."""
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        from whisper_ipa.models import flatten_params
        from whisper_ipa.train.checkpoints import load_safetensors_flat
        from whisper_ipa.train.loop import train

        config_mod.CONFIGS["test-micro"] = replace(
            config_mod.CONFIGS["test-tiny"], name="test-micro"
        )
        outs = {}
        for spc in (1, 4):
            out = str(tmp_path / f"run_spc{spc}")
            summary = train(
                model_name="test-micro",
                train_data_path=dataset_json,
                test_data_path=dataset_json,
                output_dir=out,
                num_steps=6,
                batch_size=2,
                learning_rate=1e-4,
                validate_every=0,
                save_every=3,
                data_parallel=False,
                final_validate=False,
                seed=11,
                steps_per_call=spc,
            )
            assert os.path.isdir(os.path.join(out, "checkpoint-3"))
            assert os.path.isdir(os.path.join(out, "checkpoint-6"))
            outs[spc] = (summary, out)

        s1, o1 = outs[1]
        s4, o4 = outs[4]
        assert s1["final_loss"] == pytest.approx(s4["final_loss"], rel=1e-5)
        a = load_safetensors_flat(
            os.path.join(o1, "checkpoint-6", "model.safetensors")
        )
        b = load_safetensors_flat(
            os.path.join(o4, "checkpoint-6", "model.safetensors")
        )
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(
                a[k], b[k], atol=1e-6,
                err_msg=f"{k} diverged between steps_per_call=1 and 4",
            )
        # the CSV still logs the same steps (multiples of 10 or <=5)
        def logged(out):
            with open(os.path.join(out, "training_log.csv")) as f:
                return [
                    int(r.split(",")[0])
                    for r in f.read().strip().splitlines()[1:]
                ]

        assert logged(o1) == logged(o4)
