"""rasr_tpu — a JAX speech recognition framework for accelerators.

A from-scratch rebuild of the capabilities of the RWTH ASR toolkit
(reference: 3dimaging/rasr) designed for accelerators: batched tensor
programs under jit (XLA compiles every hot op), and jax.sharding
meshes for scale-out — replacing the reference's frame-pull Flow
networks, lazy FSA expansion, and file-merge job parallelism.

Subpackages
-----------
utils     : config system (RASR selector semantics), components, logging,
            statistics, archives          (ref: src/Core/)
corpus    : Bliss corpus / lexicon / audio I/O (ref: src/Bliss/, src/Audio/)
ops       : feature frontend, Viterbi DP, segment reductions
                                           (ref: src/Signal/, src/Flow/)
models    : GMM mixture sets, HMM topology/TDP, allophones, state tying,
            CART, n-gram LMs, NN models, feature scorers
            (ref: src/Mm/, src/Am/, src/Cart/, src/Lm/, src/Nn/)
align     : forced alignment               (ref: src/Speech/Aligner)
search    : prefix-tree beam decoder       (ref: src/Search/)
lattice   : word lattices, FLF-style processing, WER (ref: src/Lattice/, src/Flf/)
fsa       : host-side weighted automata    (ref: src/Fsa/)
train     : EM / LDA / NN training loops   (ref: src/Speech/, src/Nn/)
parallel  : device mesh + sharding helpers (new; ref has file-based DP only)
pipeline  : corpus visiting and task drivers (ref: src/Speech/)
tools     : CLI tools mirroring src/Tools/
"""

__version__ = "0.1.0"
