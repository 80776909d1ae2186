"""Model registry, with the JAX package's names
(demo2program_tpu/models/registry.py; the reference's `trainer.py:18-30`)."""


def get_model_class(model_name):
    if model_name == "synthesis_baseline":
        from demo2program_tpu_torch.models.synthesis import SynthesisModel
        return SynthesisModel
    if model_name == "summarizer":
        from demo2program_tpu_torch.models.summarizer import SummarizerModel
        return SummarizerModel
    if model_name == "full":
        from demo2program_tpu_torch.models.full import FullModel
        return FullModel
    if model_name == "induction_baseline":
        from demo2program_tpu_torch.models.induction import InductionModel
        return InductionModel
    raise ValueError(model_name)
