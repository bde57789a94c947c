from repro_torch.data.pipeline import TelemetryPipeline, TokenPipeline

__all__ = ["TokenPipeline", "TelemetryPipeline"]
