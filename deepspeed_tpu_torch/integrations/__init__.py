"""HuggingFace interop: checkpoints in and out (:mod:`.hf`) and the
``Trainer`` bridge (:mod:`.trainer`)."""
