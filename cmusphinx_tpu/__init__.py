"""cmusphinx_tpu — a JAX/XLA/Pallas Sphinx-class speech recognition framework.

A from-scratch reimplementation of the capabilities of the CMU Sphinx ecosystem
(PocketSphinx, Sphinx-3, SphinxTrain, cmuclmtk) designed for an accelerator:

- MFCC/cepstral frontend as batched, fused XLA programs (framing, FFT, mel
  filterbank, DCT, CMN/AGC, deltas, LDA/MLLT).
- GMM senone scoring (semi-continuous, PTM, continuous) as batched
  matmul + log-sum-exp over device-resident codebooks.
- Viterbi beam search (lexicon-tree N-gram, FSG/JSGF grammar, allphone,
  forced alignment) as dense per-frame token passing under `lax.scan`.
- Word lattices with bestpath / posteriors / A* N-best.
- Baum-Welch training data-parallel over utterances with `psum` accumulator
  reduction over a `jax.sharding.Mesh`.

Interoperates with the reference model zoo: reads Sphinx-3 binary model
formats (mdef, means/variances, mixture_weights, sendump, transition_matrices),
ARPA and DMP language models, pronunciation dictionaries, FSG and JSGF
grammars, and MFC cepstra files.
"""

__version__ = "0.1.0"
