"""Dense GQA language model: layers, attention, stack, top level."""
