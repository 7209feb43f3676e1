"""The PyTorch render engine: compiles Waveform IR into block-render
programs that run on the CPU or on a CUDA card."""

from .graph import (CompiledVoice, EngineConfig, compile_voice, render,
                    structure_key)

__all__ = ["CompiledVoice", "EngineConfig", "compile_voice", "render",
           "structure_key"]
