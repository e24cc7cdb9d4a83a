"""The reduced-LLM substrate: configs, parameters, layers and the
decoder's prefill and decode (counterpart of ``repro.models``)."""
