"""OpenAI-compatible chat client, standard library only, no openai or vllm
dependency (counterpart of ``rsuper_tpu/report_extraction/client.py``).

The reference drives a fleet of local vLLM servers through the OpenAI API
(``report_extraction/RadGPT.py:30-130`` ``InitializeOpenAIClient`` /
``SendMessageAPI`` with ThreadPool batching; ``LaunchMultiGPUFlex.sh`` starts
one server per GPU). This client speaks the same ``/v1/chat/completions``
protocol over plain HTTP with retries and a thread pool — any vLLM / TGI /
OpenAI-compatible endpoint works.
"""

from __future__ import annotations

import concurrent.futures as futures
import json
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence


class LLMClient:
    def __init__(
        self,
        base_url: str = "http://localhost:8000/v1",
        model: str = "meta-llama/Llama-3.1-70B-Instruct-AWQ",
        api_key: str = "EMPTY",
        timeout: float = 300.0,
        max_retries: int = 3,
        temperature: float = 0.0,
        max_tokens: int = 2048,
    ):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.timeout = timeout
        self.max_retries = max_retries
        self.temperature = temperature
        self.max_tokens = max_tokens

    def chat(self, system: str, user: str) -> str:
        payload = json.dumps(
            {
                "model": self.model,
                "messages": [
                    {"role": "system", "content": system},
                    {"role": "user", "content": user},
                ],
                "temperature": self.temperature,
                "max_tokens": self.max_tokens,
            }
        ).encode()
        req = urllib.request.Request(
            self.base_url + "/chat/completions",
            data=payload,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.api_key}",
            },
        )
        last_err: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    out = json.loads(resp.read())
                return out["choices"][0]["message"]["content"]
            except Exception as e:  # noqa: BLE001 — network layer, retry all
                last_err = e
                time.sleep(2.0**attempt)
        raise RuntimeError(f"LLM request failed after retries: {last_err}")

    def chat_batch(
        self, system: str, users: Sequence[str], workers: int = 8
    ) -> List[Optional[str]]:
        """Threaded batch (reference SendMessageAPI ThreadPool); failures → None."""
        def one(u):
            try:
                return self.chat(system, u)
            except Exception:
                return None

        with futures.ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(one, users))
