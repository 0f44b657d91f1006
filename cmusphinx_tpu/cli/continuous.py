"""Continuous decoder CLI (pocketsphinx_continuous capability, file mode).

Reference: pocketsphinx/src/programs/continuous.c — live decoding with
cont_ad VAD segmentation.  Microphone capture isn't available in this
environment; `-infile` mode (the reference supports it too) segments a long
recording with the VAD and decodes each speech segment:

    python -m cmusphinx_tpu.cli.continuous -hmm DIR -lm LM -dict DICT \
        -infile audio.raw [-platform cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from ..api import DECODER_ARGS, Decoder
from ..utils.config import Arg, Config
from .batch import parse_argv

CONT_ARGS = [
    Arg("infile", str, "",
        "Audio file to transcribe (16-bit headerless PCM, or .wav)"),
    Arg("vad_delta", float, 9.0, "Speech onset threshold over noise floor (dB)"),
    Arg("partials", bool, False,
        "Print streaming partial hypotheses during speech segments "
        "(gst-plugin partial-result bus messages)"),
    Arg("platform", str, "", "Force a JAX platform (e.g. cpu)"),
]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_argv(argv)
    from ..frontend.fe import FE_ARGS
    from ..frontend.feat import FEAT_ARGS
    from ..decode.ngram_search import NGRAM_ARGS
    cfg = Config(DECODER_ARGS, FE_ARGS, FEAT_ARGS, NGRAM_ARGS).register(CONT_ARGS)
    cfg.update(**kv)
    if str(cfg["platform"]):
        import jax
        jax.config.update("jax_platforms", str(cfg["platform"]))
    if not str(cfg["infile"]):
        raise SystemExit("-infile is required (no audio device in this environment)")
    from ..frontend.source import RawFileSource, WavFileSource
    from ..pipeline import SpeechPipeline
    dec = Decoder(cfg)
    sr = float(cfg["samprate"])
    path = str(cfg["infile"])
    src = (WavFileSource(path) if path.endswith(".wav")
           else RawFileSource(path, sample_rate=sr))

    def on_partial(text, t):
        if bool(cfg["partials"]) and text:
            print(f"  partial @{t:7.2f}s: {text}", flush=True)

    n_segments = 0

    def on_result(hyp, t0, t1):
        nonlocal n_segments
        n_segments += 1
        print(f"[{t0:8.2f} - {t1:8.2f}] {hyp.text}", flush=True)

    pipe = SpeechPipeline(dec, on_partial=on_partial, on_result=on_result,
                          vad_delta=float(cfg["vad_delta"]),
                          sample_rate=src.sample_rate)
    pipe.run(src)
    src.close()
    if n_segments == 0:
        print("(no speech detected)")
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())
