"""The exchange IR's knobs.  Only the whole-step knob is ported
(``interp.py``); the IR itself waits for ROADMAP Queue A item 11."""
