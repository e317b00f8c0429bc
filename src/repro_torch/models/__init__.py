"""The dense LM stack of the port: parameter specs, attention, FFN, blocks
and the model's forward and decode entry points."""
