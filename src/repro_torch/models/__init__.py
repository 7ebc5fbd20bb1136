"""The LM substrate in torch: layers, attention, the RG-LRU block, the
layer stack and the model with its serving calls and loss
(``model.py``)."""
