"""Single-device training (port of ``repro/train``): AdamW, the synthetic
data stream and the train loop."""
