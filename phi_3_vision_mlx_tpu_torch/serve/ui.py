"""Gradio chat UI driving an Agent (counterpart of
``phi_3_vision_mlx_tpu/serve/ui.py``).

The history and agent bookkeeping live in :class:`ChatSession`, testable
without gradio; :func:`chat_ui` is thin gradio wiring on top.  gradio is an
optional dependency, imported where :func:`chat_ui` runs: without it
:func:`chat_ui` raises ``ImportError`` and the rest of the package is
unaffected.
"""

from __future__ import annotations

END_TAG = "<|end|>"


class ChatSession:
    """Chat history + agent turn bookkeeping.

    History entries are gradio chatbot pairs ``(user, assistant)`` where
    either side may be text or an ``(image_path,)`` tuple.  ``_turn_start``
    marks where the current user turn (possibly several uploaded images plus
    one text message) began.
    """

    def __init__(self, agent):
        self.agent = agent
        self.history: list = []
        self._turn_start = 0

    # -- user side ----------------------------------------------------------

    def add_user_message(self, text, files) -> list:
        for path in files or []:
            self.history.append(((path,), None))
        if text is not None:
            self.history.append((text, None))
        return self.history

    # -- agent side ---------------------------------------------------------

    def _turn_inputs(self):
        """(prompt, images) of the current turn: last text message + any
        image uploads since the previous agent response."""
        prompt = self.history[-1][0]
        uploads = [
            entry[0][0] for entry in self.history[self._turn_start : -1]
        ]
        return prompt, (uploads or None)

    @staticmethod
    def _clean(response: str) -> str:
        """Trim at the chat terminator and drop blank lines."""
        if END_TAG in response:
            response = response[: response.find(END_TAG)]
        return "\n".join(ln for ln in response.splitlines() if ln.strip())

    def run_agent(self) -> list:
        result = self.agent(*self._turn_inputs())
        responses = result.get("responses")
        if isinstance(responses, str):
            responses = [responses]
        for response in responses or []:
            self.history.append((None, self._clean(response)))
        for path in result.get("files") or []:
            if path is not None:
                self.history.append((None, (path,)))
        self._turn_start = len(self.history)
        return self.history

    def reset(self) -> list:
        self.agent.end()
        self.history = []
        self._turn_start = 0
        return self.history


def chat_ui(agent=None):
    """The chat window over ``agent`` (default: ``Agent()`` on the card)."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "chat_ui requires gradio (`pip install gradio`); the HTTP server "
            "(phi_3_vision_mlx_tpu_torch.serve.server) has no extra dependencies."
        ) from e
    from ..agent.agent import Agent

    session = ChatSession(agent if agent is not None else Agent())

    def on_submit(message):
        history = session.add_user_message(message["text"], message["files"])
        return history, gr.MultimodalTextbox(value=None, interactive=False)

    with gr.Blocks(css="footer{display:none !important}") as demo:
        chatbot = gr.Chatbot(
            [], elem_id="chatbot", bubble_full_width=False, height="80vh"
        )
        box = gr.MultimodalTextbox(
            interactive=True,
            file_types=["image"],
            placeholder="Enter message or upload file...",
            show_label=False,
        )
        reset_btn = gr.Button("Reset", variant="stop")

        submitted = box.submit(on_submit, [box], [chatbot, box])
        responded = submitted.then(
            lambda: session.run_agent(), None, chatbot, api_name="bot_response"
        )
        responded.then(lambda: gr.MultimodalTextbox(interactive=True), None, [box])
        reset_btn.click(lambda: session.reset(), None, chatbot)
    demo.queue()
    demo.launch(inbrowser=True, inline=True)


def main():
    """Console entry point of the chat UI (no console script is installed:
    ``python -m phi_3_vision_mlx_tpu_torch.serve.ui``)."""
    chat_ui()


if __name__ == "__main__":
    main()
