"""Device pipelines: the relay step and megabatch pass, and the config-5
transcode ladder."""

from .transcode_pipeline import TranscodeConfig, TranscodePipeline

__all__ = ["TranscodeConfig", "TranscodePipeline"]
