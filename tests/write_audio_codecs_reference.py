"""Writes ``reference.npz`` beside the MP3 and Ogg Vorbis fixtures of
dali_tpu_torch's audio decode (``dali_tpu_torch/testdata/audio_codecs``):
dali_tpu's FFmpeg decode (``dali_tpu.native.audio_decode``) of every short
fixture, float32 PCM under the fixture's name and its rate under
``name:rate``. The card's machine has no FFmpeg, so ``chip_smoke.py`` holds
the port against these there; ``test_fixture_matches_dali_tpu`` in
``test_torch_mp3.py`` and ``test_torch_vorbis.py`` holds them against the
live reference. It also checks that the reference fails on the damaged
fixtures (``fail_*``) and decodes the Layer II and Ogg Opus/FLAC ones.

It lives outside the port's package because it imports dali_tpu. Run it on
a machine where dali_tpu's native library has FFmpeg, from the repo root,
after ``dali_tpu_torch/testdata/make_audio_codecs.py`` wrote the streams:

    python tests/write_audio_codecs_reference.py [fixture_dir]
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "dali_tpu_torch", "testdata", "audio_codecs")


def _is_fixture(name):
    return (name.startswith("mp3_") and name.endswith(".mp3")) or (
        name.startswith("vorbis_") and name.endswith(".ogg"))


def reference_decodes(fixture_dir=FIXTURES):
    """{key: float32 PCM, key + ":rate": rate} of every fixture in
    ``fixture_dir``; raises where the reference fails on a fixture or
    decodes a ``fail_*`` stream that it should fail on."""
    import dali_tpu.native as reference

    out = {}
    for name in sorted(os.listdir(fixture_dir)):
        if not (_is_fixture(name) or name.startswith("fail_")):
            continue
        with open(os.path.join(fixture_dir, name), "rb") as f:
            got = reference.audio_decode(f.read())
        if name.startswith("fail_"):
            if (got is not None) != ("layer2" in name or "ogg" in name):
                raise RuntimeError(f"{name}: the reference {'decodes' if got else 'fails'}")
            continue
        if got is None:
            raise RuntimeError(f"the reference does not decode {name}")
        key = name.rsplit(".", 1)[0]
        out[key] = got[0].astype(np.float32)
        out[key + ":rate"] = np.float64(got[1])
    return out


def main(fixture_dir=FIXTURES):
    np.savez_compressed(os.path.join(fixture_dir, "reference.npz"),
                        **reference_decodes(fixture_dir))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(*sys.argv[1:2])
