from repro_torch.data.pipeline import PairedCorpus, SyntheticGraphCorpus

__all__ = ["PairedCorpus", "SyntheticGraphCorpus"]
