"""The LM substrate in torch: layers, attention, the RG-LRU block, the
layer stack and the serving model (``model.py``)."""
