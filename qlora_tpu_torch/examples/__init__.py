"""The port's examples, each runnable with ``python -m`` and exposing
``main(argv=None)``: one prompt through ``generate()``
(``guanaco_generate``), a terminal chat (``chat_demo``), batch serving over
``PagedBatcher`` (``serve_demo``) and a streaming web chat (``web_demo``).

Each reaches its model and tokenizer through the module-level helpers
``load_model`` and ``load_tokenizer`` (see ``_load``), so that a caller
without an HF checkpoint or ``transformers`` can hand in its own.  Each runs
on CUDA unless ``--device`` names another device."""
