"""The model stack of the port: configs in, logits and decode caches out."""
