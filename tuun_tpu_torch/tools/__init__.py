"""Tools of the port: the local web runtime (web_demo), the docs-corpus
checker (web_checker), the block profiler (profile), offline scope and
spectrum plots (scope), instrument analysis (spectra), the
phase-accumulation study (sweep) and the controller probe (midi_probe)."""
