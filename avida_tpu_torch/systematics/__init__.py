"""Host-side systematics: the live phylogeny (genotypes.py)."""

from avida_tpu_torch.systematics.genotypes import Genotype, GenotypeArbiter

__all__ = ["Genotype", "GenotypeArbiter"]
