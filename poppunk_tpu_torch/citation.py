"""Citations and auto-generated methods paragraph.

Counterpart of PopPUNK/citation.py: prints the papers to cite and a methods
paragraph templated from the actual run parameters. The method lineage is
the same (PopPUNK clustering over BinDash-style b-bit one-permutation
MinHash sketches of ntHash k-mer hashes); this implementation additionally
cites PyTorch, in which its compute core runs on a CUDA card.

Copied from ``poppunk_tpu/citation.py``, whose counterpart it is: this
package imports nothing of the JAX package. The compute stack it names is
this package's.
"""

import os
import sys

from . import __version__

CITATIONS = """If you use poppunk_tpu_torch, please cite:

PopPUNK (the method):
  Lees JA, Harris SR, Tonkin-Hill G, Gladstone RA, Lo SW, Weiser JN,
  Corander J, Bentley SD, Croucher NJ. Fast and flexible bacterial genomic
  epidemiology with PopPUNK. Genome Research 29:304-316 (2019).
  doi:10.1101/gr.241455.118

Sketching algorithms:
  Ondov BD et al. Mash: fast genome and metagenome distance estimation
  using MinHash. Genome Biol 17:132 (2016). doi:10.1186/s13059-016-0997-x
  Zhao X. BinDash, software for fast genome distance estimation on a
  typical personal laptop. Bioinformatics 35:671-673 (2019).
  doi:10.1093/bioinformatics/bty651
  Mohamadi H, Chu J, Vandervalk BP, Birol I. ntHash: recursive nucleotide
  hashing. Bioinformatics 32:3492-3494 (2016).
  doi:10.1093/bioinformatics/btw397

Compute stack:
  Paszke A et al. PyTorch: an imperative style, high-performance deep
  learning library. NeurIPS 32:8024-8035 (2019).
"""


def print_citation(args, assign=False):
    sys.stdout.write(CITATIONS + "\n")
    sys.stdout.write(generate_methods(args, assign))


def generate_methods(args, assign=False):
    """Methods paragraph from run parameters (citation.py:44-140)."""
    try:
        from .io.hdf5db import get_db_kmers, get_sketch_size

        db = args.ref_db if getattr(args, "ref_db", None) else None
        if db and os.path.isdir(db):
            kmers = list(get_db_kmers(db))
            sketch_size, _ = get_sketch_size(db)
            sketch_text = (
                f"with k-mer lengths {min(kmers)}-{max(kmers)} and a sketch "
                f"size of {sketch_size * 64}"
            )
        else:
            sketch_text = "(database parameters unavailable)"
    except Exception:
        sketch_text = "(database parameters unavailable)"

    mode = "Query assignment was performed" if assign else \
        "Genomes were clustered"
    return (
        f"Methods: {mode} with poppunk_tpu_torch v{__version__}, a GPU "
        f"implementation of the PopPUNK method (Lees et al. 2019). Genomes "
        f"were sketched using b-bit one-permutation MinHash over canonical "
        f"ntHash k-mer hashes {sketch_text}; core and accessory distances "
        f"were estimated from per-k Jaccard indices by constrained "
        f"log-linear regression, computed on a CUDA GPU via PyTorch.\n"
    )
