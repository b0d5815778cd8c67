"""gemma2-9b's decode sampler: vocabulary 256,000, top-k 64 and top-p 0.95
(its generation config) [arXiv:2408.00118; hf].  The 256k vocabulary is
where the truncated draw's no-sort path pays.  The model configuration
itself comes with ROADMAP slice 12."""

from repro_torch.configs.base import SamplerSpec

SAMPLER = SamplerSpec(top_k=64, top_p=0.95)
VOCAB_SIZE = 256000
